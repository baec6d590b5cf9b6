"""The benchmark's runner: one cell, one seed, one window.

A cell names a configuration and a traffic mix (``BENCHMARK.json``).  The
configuration names its family, ``families/<family>.py``, whose ``Family``
builds the deployment through the program and afterwards hands what the
program produced to the plain reference; the mix names its operation,
``ops/<op>.py``, whose ``run(family, spans)`` is one operation of the
window.  Everything that belongs to one configuration, one mix, one
operation, one family or one metric is found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``ops/<op>.py``,
``families/<family>.py`` and ``metrics/<metric>.py`` (or
``metrics/<part before the first dot>.py``), so a cell, an operation, a
family or a metric is added with files alone.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------ definitions

def load_benchmark(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", (cell,))]


def _module(kind: str, stem: str, bench_dir: Path):
    path = bench_dir / kind / f"{stem}.py"
    if not path.exists():
        return None
    name = f"bench_{kind}_{stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str, bench_dir: Path = BENCH_DIR):
    """The ``Family`` class of ``families/<name>.py``."""
    mod = _module("families", name, bench_dir)
    if mod is None:
        raise FileNotFoundError(f"no family {name!r}")
    return mod.Family


def operation(name: str, bench_dir: Path = BENCH_DIR):
    """The ``run(family, spans)`` function of ``ops/<name>.py``: one
    operation, returning its units of work and its latency (or None)."""
    mod = _module("ops", name, bench_dir)
    if mod is None:
        raise FileNotFoundError(f"no operation {name!r}")
    return mod.run


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of metric ``name``: from
    ``metrics/<name>.py``, else from ``metrics/<name up to its first
    dot>.py``, which serves every suffix of one quantity."""
    for stem in (name, name.split(".")[0]):
        mod = _module("metrics", stem, bench_dir)
        if mod is not None:
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


# ----------------------------------------------------------------- spans

class Spans:
    """Host spans by name, on the wall clock the profiler's trace also
    uses (``time.time_ns``).  Off, ``span`` records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.records: list[tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.records.append((name, t0, time.time_ns()))

    def durations(self, name: str, since_ns: int = 0) -> list[float]:
        """Seconds of every span ``name`` that began at ``since_ns`` or
        later."""
        return [(t1 - t0) / 1e9 for n, t0, t1 in self.records
                if n == name and t0 >= since_ns]


# ---------------------------------------------------------------- window

@dataclass
class Window:
    """What the measured window did: operations attempted, completed and
    failed, the units of work each completed (bytes, transactions), the
    latency of each, and the window's real length."""

    start_ns: int = 0
    elapsed_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    failed: int = 0
    units: float = 0.0
    latencies_s: list[float] = field(default_factory=list)
    op_s: list[float] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)


def quantile(values: list[float], q: float) -> float:
    """The q-quantile by the inclusive method (q in (0, 1))."""
    if len(values) == 1:
        return values[0]
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return cuts[round(q * 100) - 1]


def measure(op, family, seconds: float, spans: Spans) -> Window:
    """Closed loop: ``op(family, spans)`` after another until ``seconds`` have
    passed; the operation in flight at the deadline is finished and the
    window is its real length."""
    win = Window()
    win.start_ns = time.time_ns()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    now = t0
    while now < deadline:
        win.attempted += 1
        try:
            with spans.span("op"):
                units, latency = op(family, spans)
        except Exception as e:          # one failed operation, counted
            win.failed += 1
            if len(win.errors) < 5:
                win.errors.append(f"{type(e).__name__}: {e}")
            now = time.perf_counter()
            continue
        t, now = now, time.perf_counter()
        win.op_s.append(now - t)
        win.completed += 1
        win.units += units
        if latency is not None:
            win.latencies_s.append(latency)
    win.elapsed_s = now - t0
    return win


class GCPauses:
    """Seconds the interpreter's cyclic collector ran, by generation,
    while counting."""

    def __init__(self):
        import gc
        self.gc = gc
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t
            self.count[g] += 1

    def __enter__(self):
        self.gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        self.gc.callbacks.remove(self._cb)


def _probe_ms() -> float:
    """Milliseconds of a fixed piece of pure Python, the least of three:
    the speed of the core the process runs on."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        sum(i * i for i in range(100_000))
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def host_sample() -> dict:
    """The host beside the window: ``/proc/stat``'s ticks of the whole
    machine and of the cores this process may run on, the model and clock
    of those cores from ``/proc/cpuinfo``, and ``_probe_ms``."""
    mine = {f"cpu{c}" for c in os.sched_getaffinity(0)}
    ticks, mhz, model = {}, [], None
    try:
        with open("/proc/stat") as f:
            for line in f:
                name, *vals = line.split()
                if name == "cpu" or name in mine:
                    ticks[name] = [int(v) for v in vals[:8]]
        with open("/proc/cpuinfo") as f:
            core = None
            for line in f:
                if line.startswith("processor"):
                    core = f"cpu{line.split(':')[1].strip()}"
                elif line.startswith("cpu MHz") and core in mine:
                    mhz.append(float(line.split(":")[1]))
                elif line.startswith("model name") and model is None:
                    model = line.split(":", 1)[1].strip()
    except OSError:
        pass
    return {"ticks": ticks, "mhz": mhz, "cpu": model,
            "probe_ms": _probe_ms()}


def host_delta(a: dict, b: dict) -> dict:
    """Seconds the whole machine and this process's cores spent stolen by
    the hypervisor and in interrupts between two samples, their clocks and
    the probe before and after."""
    hz = os.sysconf("SC_CLK_TCK")
    out = {"probe_ms": [a["probe_ms"], b["probe_ms"]],
           "mhz": [a["mhz"], b["mhz"]], "cpu": b["cpu"]}
    for name, key in (("cpu", "all"), ("mine", "mine")):
        rows = [n for n in b["ticks"] if (n == "cpu") == (name == "cpu")]
        if not rows:
            continue
        d = [sum(b["ticks"][n][i] - a["ticks"].get(n, b["ticks"][n])[i]
                 for n in rows) / hz for i in range(8)]
        out[f"steal_s_{key}"] = d[7]
        out[f"irq_s_{key}"] = d[5] + d[6]
        out[f"busy_s_{key}"] = d[0] + d[1] + d[2]
    return out


def reservoir_slot(i: int, k: int, rng) -> int | None:
    """The slot of the i-th item (from 0) in a seeded reservoir sample of
    ``k`` items, or None when it is not kept."""
    slot = i if i < k else int(rng.integers(0, i + 1))
    return slot if slot < k else None


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})
