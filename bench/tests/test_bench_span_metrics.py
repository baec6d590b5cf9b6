"""The per-layer metrics that read the program's own spans and check
counter: a small traced run of each cell reports them, the span readers
keep to the window on the Unix clock, and every reader reads nothing
(without raising) where the program lacks what it reads or the span ring
lost part of the window."""
import importlib.util

import pytest

from bench.harness import core
from bench.harness.runner import Run
from bench.tests import tiny
from repro_torch import obs

NEW = {"analytics.scattered-commit": ("splice_ms.commit", "gather_ms.commit",
                                      "rebuilt_MB.commit", "flush_ms.commit",
                                      "check_ms.commit"),
       "analytics.checkout": ("check_ms.checkout",)}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_tiny_traced_run_reports_its_new_metrics(cell):
    names = {m["name"] for m in core.metrics_of(tiny.bench(), cell, True)}
    assert set(NEW[cell]) <= names
    result, _ = tiny.run(cell, trace=True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW[cell]) <= set(got)
    assert all(got[n] > 0 for n in NEW[cell])
    if cell == "analytics.scattered-commit":
        assert got["gather_ms.commit"] <= got["splice_ms.commit"] \
            <= got["put_ms.commit"]
        # the splice rebuilds from the first edit to the last, at most
        # the whole dataset: its bytes and a window's warm-up
        size = tiny.config_of(cell)["records"] * 400 / 1e6
        assert got["rebuilt_MB.commit"] <= size
    else:
        assert got["check_ms.checkout"] <= got["read_ms.checkout"]


def _span(name, start_ns, end_ns, **attrs):
    sp = obs.Span(name, attrs, None)
    sp.start_ns, sp.end_ns = start_ns, end_ns
    return sp


def _run(start_ns, elapsed_s, completed=2, before=None, after=None):
    win = core.Window(start_ns=start_ns, elapsed_s=elapsed_s,
                      completed=completed)
    return Run(win, 0.0, core.Spans(False), before or {}, after or {})


@pytest.fixture
def ring(monkeypatch):
    """A span ring of the program's, holding spans made by hand."""
    ring = obs.SpanRing(capacity=8)
    monkeypatch.setattr(obs, "SPANS", ring)
    return ring


def test_span_readers_keep_to_the_window(ring):
    t0 = obs.now_ns()
    run = _run(obs.unix_ns(t0), 1.0)
    ms = 1_000_000
    for sp in (_span("tree.splice", t0 - 5 * ms, t0 - ms, rechunked=7),
               _span("tree.splice", t0 + ms, t0 + 4 * ms, rechunked=3_000_000),
               _span("tree.splice", t0 + 10 * ms, t0 + 12 * ms,
                     rechunked=1_000_000),
               _span("splice.gather", t0 + 2 * ms, t0 + 3 * ms),
               _span("buffer.flush", t0 + 5 * ms, t0 + 9 * ms),
               _span("tree.splice", t0 + 1000 * ms, t0 + 1001 * ms,
                     rechunked=9)):
        ring.add(sp)
    read = {n: core.reader(f"{n}.commit")(run) for n in
            ("splice_ms", "gather_ms", "flush_ms", "rebuilt_MB")}
    assert read == {"splice_ms": 2.5, "gather_ms": 0.5, "flush_ms": 2.0,
                    "rebuilt_MB": 2.0}


def test_span_readers_read_nothing_when_the_ring_lost_the_window(ring):
    t0 = obs.now_ns()
    run = _run(obs.unix_ns(t0), 1.0)
    for i in range(10):                  # 2 dropped, inside the window
        ring.add(_span("tree.splice", t0 + i, t0 + i + 1_000_000))
    assert ring.dropped_end_ns == t0 + 1 + 1_000_000
    assert core.reader("splice_ms.commit")(run) is None
    ring.clear()
    for i in range(9):                   # 2 dropped, before the window
        ring.add(_span("tree.splice", t0 - 100 + i, t0 - 90 + i))
    ring.add(_span("tree.splice", t0 + 1, t0 + 2_000_001))
    assert 0 < obs.unix_ns(ring.dropped_end_ns) < \
        run.window.start_ns
    assert core.reader("splice_ms.commit")(run) == 1.0


def test_readers_read_nothing_from_a_program_without_them(monkeypatch):
    run = _run(0, 1.0, before={"store": {"verifies": 1}},
               after={"store": {"verifies": 9}})
    monkeypatch.delattr(obs, "SPANS")
    for name in NEW["analytics.scattered-commit"] + NEW["analytics.checkout"]:
        assert core.reader(name)(run) is None, name
    # checks counted but untimed (observability off): nothing to read
    off = _run(0, 1.0, before={"store": {"verifies": 1, "verify_ns": 5}},
               after={"store": {"verifies": 9, "verify_ns": 5}})
    assert core.reader("check_ms.commit")(off) is None
    on = _run(0, 1.0, before={"store": {"verifies": 1, "verify_ns": 5}},
              after={"store": {"verifies": 9, "verify_ns": 4_000_005}})
    assert core.reader("check_ms.checkout")(on) == 2.0


def _idle_by_span():
    path = core.REPO / "experiments" / "torch" / "idle_by_span.py"
    spec = importlib.util.spec_from_file_location("idle_by_span", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_by_span_names_kernel_time_by_span():
    from bench.harness.trace import KERNELS
    ibs = _idle_by_span()
    events = [("ns::fphash_host_kernel<x>", 0, 10),
              ("ns::fphash_host_kernel<x>", 40, 50),
              ("ns::chunker_kernel<y>", 20, 30)]
    spans = [("splice.chunk", 18, 28), ("tree.load", 0, 5),
             ("tree.read", 4, 8), ("tree.read", 40, 60)]
    share = ibs.kernel_share(events, spans, KERNELS)
    assert share["chunker_kernel"] == {"splice.chunk": 0.8}
    assert share["fphash_host_kernel"] == {"tree.load": 0.25,
                                           "tree.read": 0.7}
    assert share["hash"] == share["fphash_host_kernel"]
    read = [("read", a, b) for n, a, b in spans if n.startswith("tree.")]
    assert ibs.kernel_share(events, read, KERNELS)[
        "fphash_host_kernel"] == {"read": 0.9}
