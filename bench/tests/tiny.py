"""Small configurations of the benchmark's cells, for CPU tests.

Besides the cells of ``BENCHMARK.json`` the tests run the cells of
``pending.json``: the ledger's, whose family, operations, metrics and
judge are here and tested, but whose deployment waits for a public source
of its value size, block size and key count before it is benchmarked.
"""
import json
from pathlib import Path

from bench.harness import core

SIZES = {"analytics": ("records", 1500), "ledger": ("accounts", 1500)}
SEED = 2**31 + 12345
PENDING = json.loads((Path(__file__).parent / "pending.json").read_text())


def bench() -> dict:
    """``BENCHMARK.json`` with the pending cells and their metrics."""
    out = core.load_benchmark()
    for key in ("workloads", "end_to_end", "per_layer"):
        out[key] = out[key] + PENDING[key]
    return out


CELLS = [c["name"] for c in bench()["workloads"]]


def config_of(cell: str) -> dict:
    name = core.cell_of(bench(), cell)["config"]
    cfg = (dict(PENDING["configs"][name]) if name in PENDING["configs"]
           else core.load_config(name))
    key, n = SIZES[cfg["family"]]
    cfg[key] = n
    return cfg


def traffic_of(cell: str) -> dict:
    """The cell's mix, with the light client's blocks every 8 queries, so
    that a short window commits some."""
    mix = core.load_traffic(core.cell_of(bench(), cell)["traffic"])
    if "block_every" in mix:
        mix["block_every"] = 8
    return mix


def planted(cell: str, fault: str):
    """The function of ``bench/control.py`` that plants ``fault``."""
    from bench import control
    return control.fault(config_of(cell)["family"], fault)


def run(cell: str, *, fault=None, seconds=0.5, trace=False, seed=SEED,
        **kw):
    from bench.harness.runner import run_cell
    kw.setdefault("bench", bench())
    if "config" not in kw:
        kw["config"] = config_of(cell)
    if "traffic" not in kw:
        kw["traffic"] = traffic_of(cell)
    plant = planted(cell, fault) if fault else None
    return run_cell(cell, seed, seconds, trace, device="cpu", plant=plant,
                    **kw)
