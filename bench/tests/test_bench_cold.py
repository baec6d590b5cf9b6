"""The cold checkout cell on the CPU, with its memory tier cut as its
dataset is at full size: a version 2.9 times the tier, so that whole
reads take most of their chunks from the segment files.  Its readers of
the segment tier read, its probes catch unchecked reads in either tier,
and the analytics family's probes cannot see the segment tier's checks
turned off."""
import shutil

import pytest

from bench.families import analytics
from bench.harness import core, gen
from bench.harness.runner import Run, run_cell
from bench.tests import tiny
from repro_torch import obs

CELL = "analytics-1m.checkout-cold"
RATIO = 2.9                   # a version over the memory tier, at 1M


def cut_tier(cell: str) -> dict:
    """The cell's test config with a memory tier of a version / RATIO."""
    cfg = tiny.config_of(cell)
    data, _ = gen.make_records(cfg["records"], tiny.SEED)
    return dict(cfg, deployment=dict(cfg["deployment"],
                                     hot_bytes=int(data.size / RATIO)))


def test_the_cold_cell_reads_through_the_segment_files():
    result, details = tiny.run(CELL, config=cut_tier(CELL), trace=True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # a whole read is one batched get: its memory-tier hits are served
    # before it promotes anything, and the tier keeps what the last read
    # promoted last, about 1 / RATIO of a version (PERF.md §6)
    assert 0 < got["hot_hit_pct.checkout"] < 50
    assert 0 < got["segment_check_ms.checkout"] \
        <= got["segment_get_ms.checkout"] <= got["read_ms.checkout"]
    assert details["completed"] >= 1


@pytest.mark.parametrize("cut", [False, True], ids=["fits", "cut"])
def test_unverified_leaves_all_three_probes_undetected(cut):
    config = cut_tier(CELL) if cut else tiny.config_of(CELL)
    result, _ = tiny.run(CELL, config=config, fault="unverified")
    assert result["checks"]["tamper_undetected"]["value"] == 3


def _segment_checks_off(fam):
    fam.db.store.cold.verify = False


@pytest.mark.parametrize("cell,undetected", [(CELL, 1),
                                             ("analytics.checkout", 0)])
def test_unchecked_segment_reads_are_caught_by_the_cold_family_alone(
        cell, undetected):
    """The segment tier's read checks off, the memory tier's kept: the
    cold family's segment probe reads 1 and the run is not correct; the
    analytics family's probes never read a chunk at rest, so its run
    stays correct (the hole the cold family closes)."""
    result, _ = run_cell(cell, tiny.SEED, 0.5, False, device="cpu",
                         bench=tiny.bench(), config=cut_tier(cell),
                         traffic=tiny.traffic_of(cell),
                         plant=_segment_checks_off)
    assert result["checks"]["tamper_undetected"]["value"] == undetected
    assert result["correct"] is (undetected == 0)


@pytest.fixture
def cold_family():
    """The cold family set up at the cut tier, after one whole read."""
    from repro_torch.kernels import ops
    ops.set_device("cpu")
    fam = core.family("analytics_cold")(cut_tier(CELL),
                                        core.load_traffic("checkout"),
                                        tiny.SEED)
    try:
        fam.setup(core.Spans(False))
        core.operation("checkout")(fam, core.Spans(False))
        yield fam
    finally:
        if fam.root is not None:
            fam.db.store.close()
            shutil.rmtree(fam.root, ignore_errors=True)


@pytest.mark.parametrize("off,want", [
    ((), (0, 0, 0)), (("cold",), (0, 1, 0)),
    (("hot", "cold"), (1, 1, 1))], ids=["checked", "cold_off", "both_off"])
def test_each_probe_reads_1_exactly_when_its_tier_reads_unchecked(
        cold_family, off, want):
    """(memory-tier probe, segment probe, the analytics family's whole-read
    probe).  The whole-read probe still sees a leaf altered in the memory
    tier at this ratio: the read's one batched get takes its hits before
    it promotes anything.  The probes leave master's bytes as they were."""
    fam = cold_family
    store = fam.db.store
    store.verify = "hot" not in off
    store.cold.verify = "cold" not in off
    got = (fam._hot_probe(), fam._cold_probe(),
           analytics.Family._read_probe(fam))
    assert got == want
    store.verify = store.cold.verify = True
    assert fam.db.get(analytics.KEY, "master").blob().read() == \
        fam._bytes_of(fam.head["master"]).tobytes()


def _run(before, after, completed=2):
    win = core.Window(start_ns=0, elapsed_s=1.0, completed=completed)
    return Run(win, 0.0, core.Spans(False), before, after)


def test_the_segment_readers_read_nothing_without_their_source(
        monkeypatch):
    get, check = (core.reader(f"{n}.checkout")
                  for n in ("segment_get_ms", "segment_check_ms"))
    timed = _run({"cold": {"verifies": 1, "verify_ns": 5}},
                 {"cold": {"verifies": 9, "verify_ns": 6_000_005}})
    assert check(timed) == 3.0
    assert check(_run({"store": {}}, {"store": {}})) is None
    untimed = _run({"cold": {"verifies": 1, "verify_ns": 5}},
                   {"cold": {"verifies": 9, "verify_ns": 5}})
    assert check(untimed) is None
    ring = obs.SpanRing(capacity=8)
    monkeypatch.setattr(obs, "SPANS", ring)
    t0 = obs.now_ns()
    run = _run({}, {})
    run.window.start_ns = obs.unix_ns(t0)
    assert get(run) is None                       # no span in the window
    sp = obs.Span("segment.get", {"chunks": 3}, None)
    sp.start_ns, sp.end_ns = t0 + 1, t0 + 8_000_001
    ring.add(sp)
    assert get(run) == 4.0
    monkeypatch.delattr(obs, "SPANS")
    assert get(run) is None
