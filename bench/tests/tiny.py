"""Small configurations of the benchmark's cells, for CPU tests.

Besides the cells of ``BENCHMARK.json`` the tests run the cells of
``pending.json``, whose families, operations, metrics and judges are here
and tested, but which the benchmark does not hold: the ledger's, whose
deployment is not benchmarked yet, and ``analytics.scattered-commit``,
whose ``commit_ms`` the card's host moves by more than a bound can hold.
A family's test size and its cells' controls and faults come from its
``faults/<family>.py`` (``bench/control.py``), so a cell or a family is
tested with no entry here.
"""
import json
from pathlib import Path

from bench import control
from bench.harness import core

SEED = 2**31 + 12345
PENDING = json.loads((Path(__file__).parent / "pending.json").read_text())


def bench() -> dict:
    """``BENCHMARK.json`` with the pending cells and their metrics."""
    out = core.load_benchmark()
    for key in ("workloads", "end_to_end", "per_layer"):
        out[key] = out[key] + PENDING[key]
    return out


def config_of(cell: str, benchmark: dict | None = None,
              bench_dir: Path = core.BENCH_DIR) -> dict:
    """The cell's config at its family's test size (``TEST_SCALE``)."""
    name = core.cell_of(benchmark or bench(), cell)["config"]
    cfg = (dict(PENDING["configs"][name]) if name in PENDING["configs"]
           else core.load_config(name, bench_dir))
    key, n = control.faults_of(cfg["family"], bench_dir).TEST_SCALE
    cfg[key] = n
    return cfg


def traffic_of(cell: str, benchmark: dict | None = None,
               bench_dir: Path = core.BENCH_DIR) -> dict:
    """The cell's mix, with the light client's blocks every 8 queries, so
    that a short window commits some."""
    mix = core.load_traffic(core.cell_of(benchmark or bench(),
                                         cell)["traffic"], bench_dir)
    if "block_every" in mix:
        mix["block_every"] = 8
    return mix


def cases(benchmark: dict, bench_dir: Path = core.BENCH_DIR) -> dict:
    """The tests' cases of every cell of ``benchmark``: ``cells``, each to
    run correct; ``broken``, (cell, fault) pairs that must come out not
    correct, each fault that applies to the cell (``control.faults``),
    ``"control"`` for its first control and its other controls by name;
    ``controls``, each cell's controls."""
    out = {"cells": [], "broken": [], "controls": {}}
    for cell in benchmark["workloads"]:
        name = cell["name"]
        cfg = config_of(name, benchmark, bench_dir)
        mix = traffic_of(name, benchmark, bench_dir)
        ctl = control.controls(cfg, mix, bench_dir)
        out["cells"].append(name)
        out["controls"][name] = ctl
        out["broken"] += [(name, f) for f in control.faults(cfg, mix,
                                                            bench_dir)]
        out["broken"] += [(name, "control")] if ctl else []
        out["broken"] += [(name, c) for c in ctl[1:]]
    return out


def run(cell: str, *, fault=None, seconds=0.5, trace=False, seed=SEED,
        **kw):
    """One run of ``cell`` on the CPU at its test size, with ``fault``, a
    control or fault of its family's ``faults/`` file, planted."""
    from bench.harness.runner import run_cell
    kw.setdefault("bench", bench())
    bench_dir = kw.setdefault("bench_dir", core.BENCH_DIR)
    if "config" not in kw:
        kw["config"] = config_of(cell, kw["bench"], bench_dir)
    if "traffic" not in kw:
        kw["traffic"] = traffic_of(cell, kw["bench"], bench_dir)
    plant = (control.fault(kw["config"]["family"], fault, bench_dir)
             if fault else None)
    return run_cell(cell, seed, seconds, trace, device="cpu", plant=plant,
                    **kw)
