"""Observability layer of the port (repro_torch.obs): metrics, spans,
events, exporters, the tier and segment events of the durable stores, the
GC events, the cluster's span fan-out and the audit daemon's quarantine
journal — the JAX package's ``tests/test_obs.py``.

Every test resets the process-wide registry/journal FIRST and builds
its stores AFTER the reset: ``REGISTRY.reset()`` drops the instrument
table, so per-instance histogram caches inside stores created before
the reset would record into orphaned instruments.
"""
import json
import threading
import time

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import Cluster, FBlob
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend
from repro_torch.storage.backend import StoreStats, TamperedChunk
from repro_torch.storage.durable import SegmentBackend, open_durable


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


# ---------------------------------------------------------------- metrics

def test_histogram_buckets_and_percentiles():
    h = obs.histogram("t_us")
    for _ in range(99):
        h.observe(3e-6)            # 3 µs -> bucket [2, 4) µs
    h.observe(1000e-6)             # one 1 ms outlier
    assert h.count == 100
    assert h.p50 == 4.0            # power-of-two upper bound
    assert h.p99 == 4.0
    assert h.percentile(1.0) == 1024.0
    assert h.max_us == pytest.approx(1000.0)
    assert h.mean_us == pytest.approx((99 * 3 + 1000) / 100)
    v = h.as_value()
    assert {"count", "sum_us", "mean_us", "p50_us", "p99_us",
            "max_us"} <= set(v)


def test_histogram_saturates_last_bucket():
    h = obs.histogram("huge_us")
    h.observe(1e6)                 # 10^12 µs: beyond the bucket range
    assert h.count == 1
    assert h.percentile(1.0) == float(1 << 39)


def test_instruments_are_shared_and_type_checked():
    assert obs.counter("c", {"a": 1}) is obs.counter("c", {"a": 1})
    obs.inc("c", 2, {"a": 1})
    obs.inc("c", 3, {"a": 1})
    assert obs.counter("c", {"a": 1}).value == 5
    with pytest.raises(TypeError):
        obs.gauge("c", {"a": 1})   # name already bound to a Counter


def test_disabled_mode_is_a_noop():
    obs.disable()
    try:
        obs.inc("dead")
        obs.set_gauge("dead_g", 7)
        obs.observe("dead_us", 1e-3)
        obs.emit("dead.event", x=1)
        obs.record_gc_pause("mark", 1e-3)
        with obs.trace("dead.span") as sp:
            assert sp is None
    finally:
        obs.enable()
    snap = obs.snapshot()
    assert snap["metrics"] == {"counters": {}, "gauges": {},
                               "histograms": {}}
    assert snap["events"] == []
    assert snap["spans"] == []
    assert snap["gc"]["slice_pauses"] == []


def test_monotonic_never_goes_backwards():
    t0 = obs.monotonic()
    t1 = obs.monotonic()
    assert t1 >= t0


# ----------------------------------------------------------------- spans

def test_trace_nesting_and_exception_closes_span():
    with obs.trace("outer", op="demo") as root:
        with obs.trace("inner") as ch:
            assert obs.current_span() is ch
        with pytest.raises(RuntimeError):
            with obs.trace("boom"):
                raise RuntimeError("bang")
        # contextvar restored even though "boom" raised
        assert obs.current_span() is root
    assert obs.current_span() is None
    roots = obs.recent_spans()
    assert roots[-1] is root
    assert [c.name for c in root.children] == ["inner", "boom"]
    boom = root.children[1]
    assert boom.error == "RuntimeError"
    assert boom.parent_id == root.span_id
    assert root.child_seconds() <= root.duration_s


def test_store_span_closed_on_backend_exception():
    store = MemoryBackend(verify=True)
    with pytest.raises(TamperedChunk):
        store.put(b"payload", b"\x00" * 32)   # wrong caller-supplied cid
    assert obs.current_span() is None
    sp = obs.recent_spans()[-1]
    assert sp.name == "store.put"
    assert sp.error == "TamperedChunk"


def test_read_timing_is_sampled_one_in_eight():
    store = MemoryBackend()
    cids = store.put_many([b"a" * 100, b"b" * 100])
    h = obs.histogram("store_get_us", {"backend": "memory"})
    store.get_many(cids)           # first multi-cid batch is sampled
    assert h.count == 1
    for _ in range(7):
        store.get_many(cids)       # next 7 skip the timer
    assert h.count == 1
    store.get_many(cids)           # 8th lands again
    assert h.count == 2
    store.get(cids[0])             # single-cid reads are never timed
    assert h.count == 2
    assert store.stats.gets == 9 * 2 + 1   # StoreStats still counts all


# --------------------------------------------------- cluster span fan-out

def test_cluster_fanout_parent_child_ids_across_servlets():
    cl = Cluster(n_nodes=4, mode="2LP")
    rng = np.random.default_rng(0)
    for i in range(8):
        cl.put(f"key-{i}", FBlob(rng.bytes(2048)))
    roots = [sp for sp in obs.recent_spans() if sp.name == "cluster.put"]
    assert len(roots) == 8
    all_ids = []
    for root in roots:
        engine = [c for c in root.children if c.name == "engine.put"]
        assert len(engine) == 1
        assert engine[0].parent_id == root.span_id
        assert root.child_seconds() <= root.duration_s
        all_ids.extend(sp.span_id for sp in root.walk())
    assert len(all_ids) == len(set(all_ids))   # ids unique across fan-out


def test_durable_cluster_put_trace_has_four_layers(tmp_path):
    # tiny hot tier: the put demotes to the segment store INSIDE the
    # tiered put, so one client put yields the full layer stack
    cl = Cluster(n_nodes=2, durable_root=str(tmp_path),
                 hot_bytes=1 << 10, segment_bytes=256 << 10)
    rng = np.random.default_rng(1)
    cl.put("doc", FBlob(rng.bytes(64 << 10)))
    root = next(sp for sp in reversed(obs.recent_spans())
                if sp.name == "cluster.put")

    # per-layer spans under one root, with per-layer backend labels
    names = [sp.name for sp in root.walk()]
    assert "engine.put" in names
    backends = {sp.attrs.get("backend") for sp in root.walk()
                if sp.name == "store.put"}
    assert {"routing", "tiered", "segment"} <= backends

    def depth(sp):
        return 1 + max((depth(c) for c in sp.children), default=0)

    assert depth(root) >= 4        # cluster -> engine -> routing -> tiered+

    # timing discipline: at every node, summed child time <= own time
    for sp in root.walk():
        assert sp.child_seconds() <= sp.duration_s * (1 + 1e-9)
        for c in sp.children:
            assert c.parent_id == sp.span_id
    put_spans = [sp for sp in root.walk() if sp.name == "store.put"]
    assert all(sp.attrs.get("chunks", 0) >= 1 for sp in put_spans)
    assert any(sp.attrs.get("bytes", 0) > 0 for sp in put_spans)
    cl.sync()


# --------------------------------------------------------------- events

def test_eventlog_ring_bound_and_jsonl_sink(tmp_path):
    path = tmp_path / "events.jsonl"
    log = obs.EventLog(capacity=4, sink_path=str(path))
    try:
        for i in range(10):
            log.emit("demo.tick", i=i, blob=b"\xff")
        assert len(log) == 4                       # ring kept bounded
        assert [e["i"] for e in log.events("demo.tick")] == [6, 7, 8, 9]
        assert log.counts()["demo.tick"] == 10     # rate survives the wrap
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert [e["i"] for e in lines] == list(range(10))
        assert all(e["kind"] == "demo.tick" and e["blob"] == "ff"
                   for e in lines)
        assert obs.counter("events_total", {"kind": "demo.tick"}).value == 10
    finally:
        log.close_sink()


def test_tier_events_demote_promote_and_torn_tail(tmp_path):
    store = open_durable(str(tmp_path / "t"), hot_bytes=1 << 10,
                         segment_bytes=64 << 10)
    raws = [bytes([i]) * 600 for i in range(8)]
    cids = store.put_many(raws)                   # overflows the hot tier
    demotes = obs.EVENTS.events("tier.demote")
    assert demotes and demotes[0]["cause"] == "overflow"
    store.flush()
    causes = {e["cause"] for e in obs.EVENTS.events("tier.demote")}
    assert "flush" in causes
    store.demote(0)                               # everything cold now
    assert store.get(cids[0]) == raws[0]
    assert obs.EVENTS.events("tier.promote")
    store.close()

    # garbage appended to the active segment is truncated on reopen and
    # journaled as a torn-tail event
    seg_dir = tmp_path / "t" / "segments"
    seg = sorted(seg_dir.glob("seg-*.seg"))[-1]
    with open(seg, "ab") as f:
        f.write(b"\x07garbage-tail")
    reopened = SegmentBackend(str(seg_dir))
    torn = obs.EVENTS.events("storage.torn_tail")
    assert torn and torn[-1]["backend"] == "segment"
    assert torn[-1]["dropped_bytes"] > 0
    assert sorted(reopened.iter_cids()) == sorted(cids)
    reopened.close()


# ----------------------------------------------- segment reopen stats

def test_segment_reopen_adopts_stats_without_double_count(tmp_path):
    root = str(tmp_path / "segs")
    store = SegmentBackend(root, segment_bytes=1 << 20)
    raws = [bytes([i]) * 100 for i in range(10)]
    cids = store.put_many(raws)
    assert store.stats.puts == 10
    phys = store.stats.physical_bytes
    store.close()

    h = obs.histogram("store_put_us", {"backend": "segment"})
    count_before = h.count
    assert count_before >= 1                      # the one live batch

    reopened = SegmentBackend(root)
    # replay re-derives the stats (replay == re-execution): the counts
    # match the original store exactly — adopted once, not added twice
    assert reopened.stats.puts == 10
    assert reopened.stats.physical_bytes == phys
    assert sorted(reopened.iter_cids()) == sorted(cids)
    # and replay never routes through the instrumented put path, so the
    # latency histogram is untouched (snapshot pulls stats, never pushes)
    assert h.count == count_before
    snap = obs.snapshot(stores={"segment": reopened.stats})
    assert snap["stores"]["segment"]["puts"] == 10
    reopened.close()


# ------------------------------------------------ durable engine spans

def test_durable_engine_put_trace_has_tier_and_segment_layers(tmp_path):
    """The single-engine counterpart of the reference's durable cluster
    trace: a tiny hot tier makes the put demote to the segment store
    INSIDE the tiered put, so one engine put yields the layer stack."""
    import numpy as np
    from repro_torch.core import FBlob, ForkBase
    db = ForkBase(durable_root=str(tmp_path), hot_bytes=1 << 10,
                  segment_bytes=256 << 10)
    rng = np.random.default_rng(1)
    db.put("doc", FBlob(rng.bytes(64 << 10)))
    root = next(sp for sp in reversed(obs.recent_spans())
                if sp.name == "engine.put")
    backends = {sp.attrs.get("backend") for sp in root.walk()
                if sp.name == "store.put"}
    assert {"tiered", "segment"} <= backends
    for sp in root.walk():
        assert sp.child_seconds() <= sp.duration_s * (1 + 1e-9)
        for c in sp.children:
            assert c.parent_id == sp.span_id
    put_spans = [sp for sp in root.walk() if sp.name == "store.put"]
    assert all(sp.attrs.get("chunks", 0) >= 1 for sp in put_spans)
    db.sync()
    snap = obs.snapshot(stores={"store": db.store.stats})
    assert json.loads(json.dumps(snap)) == snap
    st = snap["stores"]["store"]
    assert st["tier_demotions"] > 0 and 0.0 <= st["tier_hit_rate"] <= 1.0


# ------------------------------------------------------------ GC events

def test_gc_events_and_slice_pause_history():
    from repro_torch.core import FBlob, ForkBase
    db = ForkBase()
    rng = np.random.default_rng(2)
    for i in range(4):
        db.put(f"k{i}", FBlob(rng.bytes(4096)))
        db.put(f"k{i}", FBlob(rng.bytes(4096)))   # garbage: old versions
    col = db.incremental_gc()
    while col.active:
        col.step(64)
    kinds = obs.EVENTS.counts()
    assert kinds.get("gc.begin", 0) >= 1
    assert kinds.get("gc.phase", 0) >= 1
    assert kinds.get("gc.done", 0) >= 1
    snap = db.observe()
    assert snap["gc"]["reports"], "GCReport history should be recorded"
    pauses = snap["gc"]["slice_pauses"]
    assert pauses and all({"phase", "epoch", "us"} <= set(p)
                          for p in pauses)
    assert "gc_slice_us" in snap["metrics"]["histograms"]
    json.dumps(snap)                                # JSON-safe


# ------------------------------------------------------- audit journal

def test_audit_quarantine_and_release_events(monkeypatch):
    from repro_torch.proof.audit import AuditDaemon, AuditFinding, AuditReport

    cl = Cluster(n_nodes=2)
    cl.put("x", FBlob(b"payload" * 64))
    daemon = AuditDaemon(cl, sample=4)
    monkeypatch.setattr(
        daemon, "_audit_target",
        lambda target: AuditReport(findings=[
            AuditFinding("node0", "corrupt", "injected corruption")]))
    rep = daemon.tick()
    assert not rep.ok and "node0" in daemon.quarantined
    quarantines = obs.EVENTS.events("audit.quarantine")
    assert quarantines and quarantines[-1]["node"] == "node0"
    assert quarantines[-1]["reason"] == "corrupt"
    assert obs.counter("audit_quarantines_total").value == 1
    assert obs.gauge("audit_quarantined_nodes").value == 1
    assert obs.EVENTS.counts().get("audit.finding", 0) >= 1

    daemon.release("node0")
    releases = obs.EVENTS.events("audit.release")
    assert releases and releases[-1]["node"] == "node0"
    assert releases[-1]["reason"] == "operator-release"
    assert obs.counter("audit_releases_total").value == 1
    assert obs.gauge("audit_quarantined_nodes").value == 0


# ------------------------------------------------------------ exporters

def test_snapshot_json_roundtrip_with_tier_and_gc(tmp_path):
    cl = Cluster(n_nodes=2, durable_root=str(tmp_path),
                 hot_bytes=4 << 10, segment_bytes=64 << 10)
    rng = np.random.default_rng(3)
    for i in range(4):
        cl.put(f"k{i}", FBlob(rng.bytes(8 << 10)))
    for i in range(4):
        assert cl.get(f"k{i}").blob().read()
    obs.record_gc_pause("mark", 123e-6, epoch=5)

    snap = cl.observe()
    blob = json.dumps(snap)                      # JSON-safe end to end
    assert json.loads(blob) == snap
    assert snap["enabled"] is True
    hists = snap["metrics"]["histograms"]
    put_keys = [k for k in hists if k.startswith("store_put_us")]
    assert put_keys
    assert all({"p50_us", "p99_us", "max_us", "count"} <= set(hists[k])
               for k in put_keys)
    assert snap["gc"]["slice_pauses"][-1] == {"phase": "mark", "epoch": 5,
                                              "us": 123.0}
    roll = snap["stores"]["cluster"]
    assert 0.0 <= roll["tier_hit_rate"] <= 1.0
    assert roll["puts"] == sum(snap["stores"][f"node{i}"]["puts"]
                               for i in range(2))
    assert snap["cluster"]["mode"] == "2LP"
    assert [sp for sp in snap["spans"] if sp["name"] == "cluster.put"]


def test_prometheus_text_renders_all_instrument_kinds():
    obs.inc("reqs_total", 3, {"verb": "put"})
    obs.set_gauge("depth", 7)
    obs.observe("lat_us", 5e-6)
    st = StoreStats(puts=2, logical_bytes=10, physical_bytes=5)
    text = obs.prometheus_text(stores={"main": st})
    assert "# TYPE reqs_total counter" in text
    assert 'reqs_total{verb="put"} 3' in text
    assert "# TYPE depth gauge" in text
    assert "depth 7" in text
    assert "# TYPE lat_us summary" in text
    assert 'lat_us{quantile="0.5"}' in text
    assert "lat_us_count 1" in text
    assert 'store_puts{store="main"} 2' in text


def test_store_stats_as_dict_and_merge():
    a = StoreStats(puts=2, gets=4, logical_bytes=100, physical_bytes=50,
                   tier_hits=3, tier_misses=1, verify_batches=2)
    b = StoreStats(puts=1, gets=1, logical_bytes=20, physical_bytes=20,
                   tier_hits=1, tier_misses=3, verify_batches=5)
    out = a.merge(b)
    assert out is a
    d = a.as_dict()
    assert d["puts"] == 3 and d["gets"] == 5 and d["verify_batches"] == 7
    assert d["logical_bytes"] == 120 and d["physical_bytes"] == 70
    assert d["dedup_ratio"] == pytest.approx(120 / 70)
    assert d["tier_hit_rate"] == pytest.approx(4 / 8)
    # exhaustive export: every dataclass field appears in the dict
    from dataclasses import fields
    assert {f.name for f in fields(StoreStats)} <= set(d)


# ------------------------------------- the span ring and the span clock

def test_span_ring_bound_and_drop_counter(monkeypatch):
    import sys
    tr = sys.modules["repro_torch.obs.trace"]
    ring = tr.SpanRing(capacity=4)
    monkeypatch.setattr(tr, "SPANS", ring)
    done = []
    for i in range(10):
        with obs.trace("tick", i=i) as sp:
            pass
        done.append(sp)
    assert ring.capacity == 4 and len(ring) == 4
    assert [sp.attrs["i"] for sp in ring.spans()] == [6, 7, 8, 9]
    assert ring.dropped_end_ns == done[5].end_ns
    assert obs.counter("spans_dropped_total").value == 6
    assert [sp.attrs["i"] for sp in ring.finished_since(done[7].end_ns)] \
        == [9, 8]
    ring.clear()
    assert (len(ring), ring.dropped_end_ns) == (0, 0)


def test_ring_keeps_every_finished_span_and_recent_spans_the_roots():
    for i in range(3):
        with obs.trace("root", i=i):
            for j in range(2):
                with obs.trace("kid", j=j):
                    with obs.trace("grandkid"):
                        pass
    names = [sp.name for sp in obs.SPANS.spans()]
    # in the order they finished: children before their parents
    assert names == (["grandkid", "kid"] * 2 + ["root"]) * 3
    roots = obs.recent_spans()
    assert [r.attrs["i"] for r in roots] == [0, 1, 2]
    assert all(r.parent_id == 0 for r in roots)
    by_id = {sp.span_id: sp for sp in obs.SPANS.spans()}
    for sp in obs.SPANS.spans():
        assert sp.start_ns <= sp.end_ns
        if sp.parent_id:
            parent = by_id[sp.parent_id]
            assert parent.start_ns <= sp.start_ns <= sp.end_ns \
                <= parent.end_ns


def test_span_ring_reads_while_other_threads_finish_spans():
    """The runtime's dispatchers finish spans on threads of their own
    while another reads the ring: a read never sees it change under it."""
    stop = threading.Event()

    def finisher():
        while not stop.is_set():
            with obs.trace("store.put"):
                pass

    threads = [threading.Thread(target=finisher) for _ in range(4)]
    for t in threads:
        t.start()
    reads = 0
    try:
        # read for a second, and on until the ring is full and wrapping
        t0 = time.perf_counter()
        while (time.perf_counter() < t0 + 1.0
               or len(obs.SPANS) < obs.SPANS.capacity
               and time.perf_counter() < t0 + 30.0):
            assert all(sp.parent_id == 0 for sp in obs.recent_spans())
            newest = obs.SPANS.finished_since(0)
            assert all(a.span_id != b.span_id
                       for a, b in zip(newest, newest[1:]))
            reads += 1
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert reads > 0 and len(obs.SPANS) == obs.SPANS.capacity


def test_snapshot_exports_the_newest_roots_only():
    for i in range(40):
        with obs.trace("op", i=i):
            pass
    spans = obs.snapshot()["spans"]
    assert [s["attrs"]["i"] for s in spans] == list(range(8, 40))


def test_a_span_maps_inside_two_unix_clock_reads():
    import time
    w0 = time.time_ns()
    time.sleep(0.001)
    with obs.trace("mapped") as sp:
        pass
    time.sleep(0.001)
    w1 = time.time_ns()
    assert w0 < obs.unix_ns(sp.start_ns) <= obs.unix_ns(sp.end_ns) < w1
    # events and snapshots share the span clock
    t0 = obs.now_ns()
    obs.emit("clock.probe")
    snap = obs.snapshot()
    ev = obs.EVENTS.events("clock.probe")[-1]
    assert t0 / 1e3 <= ev["mono_us"] <= snap["now_us"] <= obs.now_ns() / 1e3


def _durable_engine(tmp_path):
    from repro_torch.core import ForkBase
    return ForkBase(durable_root=str(tmp_path), verify_get=True,
                    hot_bytes=256 << 10, segment_bytes=64 << 10)


def _tree(root):
    return {sp.name: [c.name for c in sp.children] for sp in root.walk()}


def test_spliced_blob_put_gives_the_write_path_span_tree(tmp_path,
                                                         monkeypatch):
    from repro_torch.core import postree
    rng = np.random.default_rng(5)
    db = _durable_engine(tmp_path)
    data = rng.bytes(96 << 10)
    db.put("doc", FBlob(data))
    db.sync()
    handed = []
    bitmap = postree.boundary_bitmap

    def counting(stream, params):
        handed.append(len(stream))
        return bitmap(stream, params)

    monkeypatch.setattr(postree, "boundary_bitmap", counting)
    obs.SPANS.clear()
    st = db.store.stats
    v0, ns0 = st.verifies, st.verify_ns
    blob = db.get("doc").blob()
    edits = [(int(p), rng.bytes(40)) for p in (1000, 30_000, 70_000)]
    for pos, new in edits:
        blob.replace(pos, len(new), new)
    db.put("doc", blob)
    db.sync()
    assert db.get("doc").blob().read() == _spliced(data, edits)

    names = [sp.name for sp in obs.recent_spans()]
    assert names == ["tree.load", "engine.put", "engine.sync",
                     "tree.load", "tree.read"]
    put = obs.recent_spans()[1]
    tree = _tree(put)
    assert tree["engine.put"] == ["tree.splice", "buffer.flush"]
    splice = put.children[0]
    assert [c.name for c in splice.children] == [
        "splice.gather", "splice.apply", "splice.chunk", "splice.encode"
    ] * splice.attrs["attempts"] + ["tree.index", "buffer.flush"]
    assert tree["buffer.flush"] == ["store.put"]
    assert splice.attrs["edits"] == len(edits)
    assert splice.attrs["rechunked"] == sum(handed) > 0
    assert splice.attrs["leaves_read"] >= 1
    assert splice.attrs["new_leaves"] >= 1
    sync = obs.recent_spans()[2]
    assert [c.name for c in sync.children] == ["tier.flush"]
    assert "segment.fsync" in [sp.name for sp in sync.walk()]
    # child time never exceeds the parent's, at every node
    for sp in put.walk():
        assert sp.child_seconds() <= sp.duration_s * (1 + 1e-9)
    assert st.verifies > v0 and st.verify_ns > ns0
    db.store.close()


def _spliced(data: bytes, edits) -> bytes:
    out = bytearray(data)
    for pos, new in edits:
        out[pos:pos + len(new)] = new
    return bytes(out)


def _check_sites(tmp_path):
    """Each site that counts a chunk check: (name, the StoreStats it
    counts in, an action that checks)."""
    from repro_torch.core.fobject import load_fobject, make_fobject
    from repro_torch.storage import LRUCacheBackend
    from repro_torch.storage.durable import TieredBackend
    rng = np.random.default_rng(7)
    raws = [rng.bytes(int(n)) for n in rng.integers(100, 3000, 6)]
    from repro_torch.core.chunk import cid_of
    cids = [cid_of(r) for r in raws]

    mem = MemoryBackend(verify=True)
    mem.put_many(raws)
    log = str(tmp_path / "chunks.log")
    logged = MemoryBackend(log_path=log, verify=True)
    logged.put_many(raws)
    logged.flush()
    cache = LRUCacheBackend(MemoryBackend(), verify=True)
    cache.put_many(raws)
    seg = SegmentBackend(str(tmp_path / "seg"), verify=True)
    seg.put_many(raws)
    seg.flush()
    hot = TieredBackend(MemoryBackend(), verify=True)
    hot.put_many(raws)
    # a batch the checks hash as one (``check_chunks``'s batched route)
    from repro_torch.storage.backend import CHECK_BATCH_MIN
    many = [rng.bytes(300) for _ in range(CHECK_BATCH_MIN)]
    many_cids = [cid_of(r) for r in many]
    hot_many = TieredBackend(MemoryBackend(), verify=True)
    hot_many.put_many(many)
    seg_many = SegmentBackend(str(tmp_path / "seg_many"), verify=True)
    seg_many.put_many(many)
    meta = MemoryBackend()
    uid = make_fobject(meta, 7, b"k", b"v", ()).uid
    replay = {}

    def reopen_log():
        replay["log"] = MemoryBackend(log_path=log, verify=True)

    def reopen_seg():
        replay["seg"] = SegmentBackend(str(tmp_path / "seg"), verify=True)

    return [
        ("memory.put", lambda: mem.stats,
         lambda: mem.put_many(raws, cids)),
        ("memory.get", lambda: mem.stats, lambda: mem.get_many(cids)),
        ("memory.replay", lambda: replay.get("log", logged).stats
         if "log" in replay else StoreStats(), reopen_log),
        ("cache.hit", lambda: cache.stats, lambda: cache.get_many(cids)),
        ("segment.put", lambda: seg.stats, lambda: seg.put_many(raws, cids)),
        ("segment.get", lambda: seg.stats, lambda: seg.get_many(cids)),
        ("segment.replay", lambda: replay["seg"].stats
         if "seg" in replay else StoreStats(), reopen_seg),
        ("tiered.put", lambda: hot.stats, lambda: hot.put_many(raws, cids)),
        ("tiered.hit", lambda: hot.stats, lambda: hot.get_many(cids)),
        ("tiered.hit_batch", lambda: hot_many.stats,
         lambda: hot_many.get_many(many_cids)),
        ("segment.get_batch", lambda: seg_many.stats,
         lambda: seg_many.get_many(many_cids)),
        ("fobject.meta", lambda: meta.stats,
         lambda: load_fobject(meta, uid, verify=True)),
        ("unverified.get", lambda: MemoryBackend().stats, lambda: None),
    ]


CHECK_SITES = ["memory.put", "memory.get", "memory.replay", "cache.hit",
               "segment.put", "segment.get", "segment.replay", "tiered.put",
               "tiered.hit", "fobject.meta", "tiered.hit_batch",
               "segment.get_batch"]


@pytest.mark.parametrize("enabled", [True, False], ids=["obs_on", "obs_off"])
@pytest.mark.parametrize("site", CHECK_SITES)
def test_verify_ns_moves_exactly_when_verifies_does(tmp_path, site, enabled):
    stats_of, act = {n: (s, a) for n, s, a in _check_sites(tmp_path)}[site]
    before = (stats_of().verifies, stats_of().verify_ns)
    (obs.enable if enabled else obs.disable)()
    try:
        act()
    finally:
        obs.enable()
    after = (stats_of().verifies, stats_of().verify_ns)
    assert after[0] > before[0], site
    if enabled:
        assert after[1] > before[1], site
    else:
        assert after[1] == before[1], site


def test_no_check_no_verify_ns():
    store = MemoryBackend()
    cids = store.put_many([b"x" * 100, b"y" * 100])
    store.get_many(cids)
    assert store.stats.verifies == 0 and store.stats.verify_ns == 0


# ------------------------------------------------- cold reads by segment

def _cold_read(core, root):
    """A blob eight times the memory tier put, synced and read back whole:
    most of the read comes from the segment files.  Returns the engine,
    the span clock at the read's start and the segment tier's gets and
    ``verify_ns`` before it."""
    rng = np.random.default_rng(11)
    db = core.ForkBase(durable_root=root, verify_get=True,
                       hot_bytes=16 << 10, segment_bytes=64 << 10)
    data = rng.bytes(128 << 10)
    db.put("doc", core.FBlob(data))
    db.sync()
    cold = db.store.cold.stats
    before = (obs.now_ns(), cold.gets, getattr(cold, "verify_ns", 0))
    assert db.get("doc").blob().read() == data
    return db, before


def test_a_cold_read_records_segment_get_spans_as_the_reference_counts(
        tmp_path):
    import repro.core as rc
    import repro_torch.core as pc
    db, (t0, gets0, ns0) = _cold_read(pc, str(tmp_path / "port"))
    cold = db.store.cold.stats
    spans = [sp for sp in obs.SPANS.spans() if sp.start_ns >= t0]
    read = next(sp for sp in spans if sp.name == "tree.read")
    gets = [sp for sp in spans if sp.name == "segment.get"]
    assert any(sp.parent_id == read.span_id for sp in gets)
    # every segment get of the read is in a span, and every check's time
    assert sum(sp.attrs["chunks"] for sp in gets) == cold.gets - gets0 > 0
    assert sum(sp.attrs["check_ns"] for sp in gets) == \
        cold.verify_ns - ns0 > 0
    assert all(sp.attrs["bytes"] > 0 for sp in gets)
    # the span changes no count: the same sequence through the reference
    # (which has neither the checks' time nor their batched hashes)
    ref, _ = _cold_read(rc, str(tmp_path / "ref"))
    for own, other in ((db.store.stats, ref.store.stats),
                       (cold, ref.store.cold.stats)):
        got = own.as_dict()
        del got["verify_ns"], got["verify_batches"]
        assert got == other.as_dict()
    assert db.store.stats.tier_misses > 0
    db.store.close()
    ref.store.close()


def test_no_segment_get_span_while_obs_is_off(tmp_path):
    import repro_torch.core as pc
    obs.disable()
    try:
        db, (_, gets0, _) = _cold_read(pc, str(tmp_path))
    finally:
        obs.enable()
    assert db.store.cold.stats.gets > gets0
    assert not [sp for sp in obs.SPANS.spans() if sp.name == "segment.get"]
    db.store.close()
