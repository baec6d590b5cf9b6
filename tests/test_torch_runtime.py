"""Async cluster runtime of the port (repro_torch.core.runtime), on the
CPU: coalesced dispatch, backpressure/admission, maintenance daemon,
quarantine enforcement, and the typed routing-miss regression — the JAX
package's ``tests/test_runtime.py``, every test of it.

Determinism: most tests drive the runtime with the synchronous
``drain()`` dispatcher; the threaded interleaving tests (a fast one in
tier 1, a big slow-marked one for the scheduled ``runtime-race`` CI
job) run real writer threads against the worker/daemon threads and
check the same invariants as ``test_gc_concurrent``: no head ever
dangles, the master index never lies, and GC after the dust settles
sweeps without eating a live chunk.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import (Backpressure, Cluster, FBlob, GuardFailed,
                              MaintenanceDaemon, RoutingIndexMiss,
                              RuntimeConfig)
from repro_torch.kernels import ops
from repro_torch.storage.backend import ChunkMissing


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.reset()
    obs.enable()
    yield
    obs.reset()
    obs.enable()


def _blob(rng, n=2048):
    return FBlob(rng.bytes(n))


# ------------------------------------------------------ coalesced dispatch

def test_coalesced_puts_match_sequential_semantics(rng):
    cl = Cluster(4)
    rt = cl.runtime()
    futs = {}
    for i in range(12):
        futs[f"k{i}"] = rt.submit_put(f"k{i}", _blob(rng))
    # same-key chain inside ONE batch: three more versions of k0
    chain = [rt.submit_put("k0", _blob(rng)) for _ in range(3)]
    assert rt.drain() == 15
    for key, f in futs.items():
        assert f.done()
        if key != "k0":
            assert cl.get(key).uid == f.result()
    # k0's head is the LAST queued put and its history is the chain
    assert cl.get("k0").uid == chain[-1].result()
    uids = [o.uid for o in cl.track("k0", "master")]
    assert uids == [chain[2].result(), chain[1].result(),
                    chain[0].result(), futs["k0"].result()]


def test_put_then_get_ordering_within_queue(rng):
    cl = Cluster(3)
    rt = cl.runtime()
    blob = _blob(rng)
    pf = rt.submit_put("ordered", blob)
    gf = rt.submit_get("ordered")
    rt.drain()
    assert gf.result() is not None
    assert gf.result().uid == pf.result()


def test_coalescing_is_fewer_store_batches(rng):
    """The point of the runtime: N requests cost ~O(nodes) routing
    put batches, not O(N)."""
    cl = Cluster(4)
    before = sum(n.servlet.store.stats.put_batches for n in cl.nodes)
    rt = cl.runtime()
    for i in range(32):
        rt.submit_put(f"bulk{i}", _blob(rng, 512))
    rt.drain()
    batched = (sum(n.servlet.store.stats.put_batches for n in cl.nodes)
               - before)
    cl2 = Cluster(4)
    before2 = sum(n.servlet.store.stats.put_batches for n in cl2.nodes)
    rng2 = np.random.default_rng(0)
    for i in range(32):
        cl2.put(f"bulk{i}", _blob(rng2, 512))
    single = (sum(n.servlet.store.stats.put_batches for n in cl2.nodes)
              - before2)
    assert batched < single


def test_get_batch_verbatim_and_missing(rng):
    cl = Cluster(3)
    rt = cl.runtime()
    blob = rng.bytes(4096)
    cl.put("present", FBlob(blob))
    g1 = rt.submit_get("present")
    g2 = rt.submit_get("never-written")
    rt.drain()
    assert g1.result().blob().read() == blob
    assert g2.result() is None


def test_guard_failure_does_not_poison_batch(rng):
    cl = Cluster(2)
    rt = cl.runtime()
    u0 = cl.put("guarded", _blob(rng))
    ok = rt.submit_put("plain", _blob(rng))
    bad = rt.submit_put("guarded", _blob(rng), guard_uid=b"\x00" * 32)
    good = rt.submit_put("guarded", _blob(rng), guard_uid=u0)
    rt.drain()
    assert ok.result()
    with pytest.raises(GuardFailed):
        bad.result()
    assert cl.get("guarded").uid == good.result()


# --------------------------------------------------- backpressure/admission

def test_backpressure_bounds_each_servlet_queue(rng):
    cl = Cluster(1)          # one servlet: every key shares the queue
    rt = cl.runtime(RuntimeConfig(queue_depth=4))
    for i in range(4):
        rt.submit_put(f"bp{i}", _blob(rng, 256))
    with pytest.raises(Backpressure) as ei:
        rt.submit_put("bp-overflow", _blob(rng, 256))
    assert ei.value.depth == 4 and ei.value.bound == 4
    assert obs.counter("runtime_backpressure_total").value == 1
    rt.drain()               # queue drains -> admission reopens
    rt.submit_put("bp-after", _blob(rng, 256))
    rt.drain()
    assert cl.get("bp-after") is not None


def test_admission_tightens_on_windowed_store_p99(rng):
    cl = Cluster(2)
    cfg = RuntimeConfig(queue_depth=64, max_batch=16,
                        admission_p99_us=1000.0)
    rt = cl.runtime(cfg)
    assert rt.admission.bound() == 64 and rt.admission.batch() == 16
    # a slow window: the routing store's put histogram jumps
    h = obs.REGISTRY.histogram("store_put_us", {"backend": "routing"})
    for _ in range(8):
        h.observe(0.05)               # 50 ms ≫ the 1 ms threshold
    assert rt.admission.update() is True
    assert rt.admission.bound() == 32 and rt.admission.batch() == 8
    assert obs.EVENTS.counts().get("runtime.congested", 0) == 1
    # a quiet window (no new samples) clears the verdict
    assert rt.admission.update() is False
    assert rt.admission.bound() == 64


def test_admission_reads_fresh_slow_spans(rng):
    cl = Cluster(2)
    rt = cl.runtime(RuntimeConfig(slow_span_us=10_000.0))
    with obs.trace("store.put", backend="routing") as sp:
        pass
    # forge the duration (we cannot sleep 10ms+ in a unit test); the
    # span is already in the ring with a fresh start on the span clock
    sp.start_ns = obs.now_ns()
    sp.end_ns = sp.start_ns + 500_000_000
    assert rt.admission.update() is True
    rt.admission.update()
    assert rt.admission.congested is False   # span is no longer fresh


def test_dispatchers_survive_spans_finishing_on_other_threads(rng):
    """Every dispatcher scans the span ring for admission while the
    others finish ``store.put``/``engine.put`` spans into it, and a
    reader exports snapshots meanwhile: no dispatcher dies, every future
    resolves, and every snapshot is taken."""
    cl = Cluster(4)
    rt = cl.runtime(RuntimeConfig(queue_depth=4096)).start()
    deadline = time.perf_counter() + 2.0
    done, errors = [], []

    def writer(w):
        r = np.random.default_rng(2000 + w)
        i = 0
        while time.perf_counter() < deadline:
            try:
                f = rt.submit_put(f"s{w}-{i % 4}", FBlob(r.bytes(512)))
                done.append(f.result(timeout=10))
            except Exception as e:       # noqa: BLE001
                errors.append(e)
                return
            i += 1

    def reader():
        while time.perf_counter() < deadline:
            try:
                snaps.append(len(obs.snapshot()["spans"]))
            except Exception as e:       # noqa: BLE001
                errors.append(e)
                return

    snaps = []
    threads = [threading.Thread(target=writer, args=(w,)) for w in range(6)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert not errors, errors[:3]
        assert all(t.is_alive() for t in rt._threads)
        assert len(done) > 6 and snaps
    finally:
        rt.stop()


# ------------------------------------------------------- typed routing miss

def test_routing_index_miss_is_typed(rng):
    """Regression: a master-index miss used to silently fall back to
    the hash owner — which holds no copy — so the read failed from the
    WRONG node with a generic miss."""
    cl = Cluster(3)
    store = cl.nodes[0].servlet.store
    ghost = bytes(32)
    with pytest.raises(RoutingIndexMiss) as ei:
        store.get_many([ghost])
    assert ei.value.cid == ghost
    assert isinstance(ei.value, ChunkMissing)     # still a KeyError
    assert "master-index" in str(ei.value)
    # membership and delete stay lenient: absent, not an error
    assert store.has_many([ghost]) == [False]
    assert store.delete_many([ghost]) == 0


def test_iter_cids_scoped_to_home_node_and_lazy(rng):
    cl = Cluster(4)
    for i in range(16):
        cl.put(f"scope{i}", _blob(rng))
    shares = []
    for ni, nd in enumerate(cl.nodes):
        it = nd.servlet.store.iter_cids()
        assert iter(it) is it, "inventory must stream, not materialize"
        share = set(it)
        owned = {cid for cid, n in cl.index.items() if n == ni}
        assert share == owned, "servlet inventory == its index share"
        shares.append(share)
    union = set().union(*shares)
    assert union == set(cl.index)
    for a in range(len(shares)):
        for b in range(a + 1, len(shares)):
            assert not (shares[a] & shares[b])


# --------------------------------------------------- quarantine enforcement

def test_quarantine_enforced_and_rereplicated(rng):
    cl = Cluster(4)
    for i in range(24):
        cl.put(f"q{i}", _blob(rng))
    victim = max(range(4), key=lambda ni: cl.nodes[ni].stats.chunks)
    had = len(cl.nodes[victim].store)
    assert had > 0
    queued = cl.quarantine_node(victim, reason="test-corruption")
    assert queued == had
    # 1) placement routes around the node: NO new chunk lands there
    before = len(cl.nodes[victim].store)
    for i in range(16):
        cl.put(f"post-q{i}", _blob(rng))
    assert len(cl.nodes[victim].store) == before
    assert all(n != victim
               for cid, n in cl.index.items()
               if cid not in set(cl.nodes[victim].store.iter_cids()))
    # 2) re-replication drains the backlog and restores availability
    assert cl.rereplicate() >= queued
    assert cl.rerep_backlog() == 0
    assert len(cl.nodes[victim].store) == 0
    assert cl.rerep_lost == 0
    assert victim not in set(cl.index.values())
    for i in range(24):
        assert cl.get(f"q{i}") is not None        # every read survives
    # 3) release: the node rejoins placement
    cl.release_node(victim)
    for i in range(32):
        cl.put(f"post-r{i}", _blob(rng))
    assert len(cl.nodes[victim].store) > 0


def test_quarantine_landing_mid_put_is_rereplicated(rng, monkeypatch):
    """A quarantine that lands after a put placed its chunks on the node
    but before the master index names them (the window the threaded
    quarantine race hits) must still drain the node: the put queues what
    the quarantine's index snapshot missed."""
    from repro_torch.core import cluster as clmod
    cl = Cluster(3)
    for i in range(6):
        cl.put(f"pre{i}", _blob(rng))
    orig = clmod.put_via
    armed = [True]

    def put_via(stats, store, raws, cids):
        out = orig(stats, store, raws, cids)
        if armed[0] and store is cl.nodes[0].store:
            armed[0] = False                 # the main thread's call lands
            cl.quarantine_node(0, reason="mid-put")
        return out

    monkeypatch.setattr(clmod, "put_via", put_via)
    i = 0
    while armed[0]:
        cl.put(f"mid{i}", _blob(rng))
        i += 1
    cl.rereplicate()
    assert 0 not in set(cl.index.values())
    assert len(cl.nodes[0].store) == 0
    assert cl.rerep_lost == 0
    for k in [f"pre{j}" for j in range(6)] + [f"mid{j}" for j in range(i)]:
        assert cl.get(k).blob().read()


def test_rereplication_drops_corrupt_copies_honestly(rng):
    cl = Cluster(3)
    for i in range(12):
        cl.put(f"c{i}", _blob(rng))
    victim = max(range(3), key=lambda ni: cl.nodes[ni].stats.chunks)
    # corrupt one chunk ON the victim before quarantining it
    cid = next(iter(cl.nodes[victim].store.iter_cids()))
    cl.nodes[victim].store._data[cid] = b"garbage-bytes"
    cl.quarantine_node(victim, reason="corrupt")
    cl.rereplicate()
    assert cl.rerep_lost == 1
    assert cid not in cl.index          # honest: typed miss, not bad bytes
    with pytest.raises(RoutingIndexMiss):
        cl.nodes[0].servlet.store.get_many([cid])


def test_audit_daemon_quarantine_reaches_routing_layer(monkeypatch):
    """audit.quarantine/audit.release findings ENFORCE, not just
    report: the daemon's direct hook calls flip Cluster.quarantined
    (so this works with REPRO_OBS=0 too)."""
    from repro_torch.proof.audit import AuditDaemon, AuditFinding, AuditReport
    rng = np.random.default_rng(1)
    cl = Cluster(2)
    for i in range(8):
        cl.put(f"a{i}", _blob(rng))
    daemon = AuditDaemon(cl, sample=4)
    monkeypatch.setattr(
        daemon, "_audit_target",
        lambda target: AuditReport(findings=[
            AuditFinding("node1", "corrupt", "injected")]))
    daemon.tick()
    assert "node1" in daemon.quarantined
    assert cl.quarantined == {1}                  # ENFORCED
    assert cl.rerep_backlog() == cl.nodes[1].stats.chunks \
        or cl.rerep_backlog() > 0 or cl.nodes[1].stats.chunks == 0
    cl.rereplicate()
    assert len(cl.nodes[1].store) == 0
    daemon.release("node1")
    assert cl.quarantined == set()                # release enforced too


def test_audit_daemon_quarantine_enforced_with_obs_disabled(monkeypatch):
    from repro_torch.proof.audit import AuditDaemon, AuditFinding, AuditReport
    rng = np.random.default_rng(2)
    cl = Cluster(2)
    for i in range(6):
        cl.put(f"d{i}", _blob(rng))
    obs.disable()
    try:
        daemon = AuditDaemon(cl, sample=4)
        monkeypatch.setattr(
            daemon, "_audit_target",
            lambda target: AuditReport(findings=[
                AuditFinding("node0", "missing", "injected")]))
        daemon.tick()
        assert cl.quarantined == {0}
        assert not obs.EVENTS.events("audit.quarantine")  # no journal...
        cl.rereplicate()                                  # ...but enforced
        assert len(cl.nodes[0].store) == 0
    finally:
        obs.enable()


# ------------------------------------------------------- maintenance daemon

def test_daemon_shares_one_budget_rerep_first(rng):
    cl = Cluster(3)
    for i in range(18):
        cl.put(f"m{i}", _blob(rng))
    victim = max(range(3), key=lambda ni: cl.nodes[ni].stats.chunks)
    queued = cl.quarantine_node(victim)
    d = MaintenanceDaemon(cl, config=RuntimeConfig(tick_budget=4,
                                                   audit_every=1000))
    rep = d.tick()
    assert rep["rerep"] == 4 and rep["budget"] == 4
    total = rep["rerep"]
    while cl.rerep_backlog():
        total += d.tick()["rerep"]
    assert total == queued
    assert len(cl.nodes[victim].store) == 0


def test_daemon_backs_off_under_foreground_load(rng):
    cl = Cluster(2)
    rt = cl.runtime(RuntimeConfig(queue_depth=64))
    cfg = RuntimeConfig(tick_budget=64, backoff_queued=2,
                        fold_every=1, compact_every=1)
    d = MaintenanceDaemon(cl, runtime=rt, config=cfg)
    for i in range(6):                 # queued, NOT drained: deep queue
        rt.submit_put(f"fg{i}", _blob(rng, 256))
    rep = d.tick()
    assert rep["backoff"] is True
    assert rep["budget"] == 16         # quarter budget
    assert rep["folds"] == 0 and rep["compactions"] == 0
    rt.drain()
    rep = d.tick()
    assert rep["backoff"] is False
    assert rep["folds"] == 1 and rep["compactions"] == 1


def test_daemon_staggers_folds_and_runs_gc_cycles(rng):
    cl = Cluster(2)
    # dirty live tables on both servlets
    for i in range(4):
        t = cl.live(f"lv{i}")
        t.put(b"f", rng.bytes(64))
    # garbage to collect: forked-then-removed branches (overwrites alone
    # stay reachable through version lineage)
    for i in range(4):
        cl.put(f"g{i}", _blob(rng))
        cl.fork(f"g{i}", "master", "tmp")
        cl.put(f"g{i}", _blob(rng), "tmp")
        cl.remove(f"g{i}", "tmp")
    cfg = RuntimeConfig(fold_every=1, audit_every=1000,
                        compact_every=1000, gc_cycle_ticks=2,
                        tick_budget=64)
    d = MaintenanceDaemon(cl, config=cfg)
    folds = 0
    for _ in range(40):
        folds += d.tick()["folds"]
        if (d.collector is not None and not d.collector.active
                and not any(t.dirty_count for t in
                            [cl.live(f"lv{i}") for i in range(4)])):
            break
    assert folds >= 2                  # round-robined across servlets
    assert d.collector is not None and not d.collector.active
    assert d.collector.report.swept_chunks > 0
    for i in range(4):                 # folded live state survives GC
        assert cl.live(f"lv{i}").get(b"f") is not None
        assert cl.get(f"g{i}") is not None


# ----------------------------------------------------- threaded interleaving

def _stress(n_nodes, writers, puts_each, rng, *, quarantine_mid=False,
            cfg=None):
    cl = Cluster(n_nodes)
    cfg = cfg or RuntimeConfig(queue_depth=4096, gc_cycle_ticks=3,
                               tick_interval_s=0.001, fold_every=2,
                               audit_every=3)
    rt = cl.runtime(cfg).start(daemon=True)
    errors: list = []
    results: dict[str, bytes] = {}
    lock = threading.Lock()

    def writer(w):
        r = np.random.default_rng(1000 + w)
        for i in range(puts_each):
            key = f"w{w}-k{i % 8}"       # 8 keys per writer, re-put often
            try:
                f = rt.submit_put(key, FBlob(r.bytes(1024)))
                uid = f.result(timeout=30)
                with lock:
                    results[key] = uid   # this writer's latest uid
            except Exception as e:       # noqa: BLE001
                errors.append((key, e))

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(writers)]
    for t in threads:
        t.start()
    if quarantine_mid:
        for t in threads:
            t.join(timeout=0.05)
        cl.quarantine_node(0, reason="mid-stress")
    for t in threads:
        t.join(timeout=60)
    rt.stop()
    assert not errors, errors[:3]
    # invariant 1: every key's head is this writer's LAST uid and reads
    for key, uid in results.items():
        h = cl.get(key)
        assert h is not None and h.uid == uid
        assert h.blob().read()
    # invariant 2: the master index never lies (placement audit clean,
    # modulo the quarantined node whose chunks may still await rerep)
    cl.rereplicate()
    from repro_torch.proof.audit import Auditor
    rep = Auditor(sample=64).audit_placement(cl)
    assert rep.ok, str(rep)
    # invariant 3: a full GC after the dust settles never eats a head
    cl.gc()
    for key, uid in results.items():
        assert cl.get(key).uid == uid
    if quarantine_mid:
        assert 0 not in set(cl.index.values())
        assert len(cl.nodes[0].store) == 0
    return cl


def test_threaded_writers_with_daemon_small(rng):
    _stress(3, writers=3, puts_each=12, rng=rng)


def test_threaded_quarantine_mid_stress_small(rng):
    _stress(3, writers=3, puts_each=12, rng=rng, quarantine_mid=True)


@pytest.mark.slow
def test_threaded_writers_with_daemon_race(rng):
    """Scheduled runtime-race job: heavy interleaving of writers,
    dispatcher workers, GC slices, audits, folds and re-replication."""
    _stress(4, writers=8, puts_each=80, rng=rng)


@pytest.mark.slow
def test_threaded_quarantine_race(rng):
    _stress(4, writers=8, puts_each=60, rng=rng, quarantine_mid=True)
