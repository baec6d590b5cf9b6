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
                   tier_hits=3, tier_misses=1)
    b = StoreStats(puts=1, gets=1, logical_bytes=20, physical_bytes=20,
                   tier_hits=1, tier_misses=3)
    out = a.merge(b)
    assert out is a
    d = a.as_dict()
    assert d["puts"] == 3 and d["gets"] == 5
    assert d["logical_bytes"] == 120 and d["physical_bytes"] == 70
    assert d["dedup_ratio"] == pytest.approx(120 / 70)
    assert d["tier_hit_rate"] == pytest.approx(4 / 8)
    # exhaustive export: every dataclass field appears in the dict
    from dataclasses import fields
    assert {f.name for f in fields(StoreStats)} <= set(d)
