"""Each cell, run on the CPU at a small size: sound runs come out correct,
and a run with the timed path broken underneath (each fault a cell can
have, and the cell's control) comes out not correct."""
import pytest

from bench.harness import core
from bench.tests import tiny

CELLS = tiny.CELLS
# each cell's controls (bench/control.py), the first named "control" here
CONTROLS = {"analytics.scattered-commit": ("skip_sync", "unverified"),
            "analytics.checkout": ("unverified",),
            "ledger.blocks": ("drop_write",),
            "ledger.light-client": ("stale_proof",)}
FAULTS = ("unchanged_state", "half_batch", "altered_answer")
# a checkout reads whole versions one at a time: it has no batch to halve
CASES = [(cell, fault) for cell in CELLS for fault in FAULTS + ("control",)
         if (cell, fault) != ("analytics.checkout", "half_batch")]
CASES += [(cell, c) for cell in CELLS for c in CONTROLS[cell][1:]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    result, details = tiny.run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] == details["completed"] >= 1
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {
        m["name"] for m in core.metrics_of(tiny.bench(), cell, False)}


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    fault = CONTROLS[cell][0] if fault == "control" else fault
    result, _ = tiny.run(cell, fault=fault)
    assert not result["correct"], (fault, result["checks"])
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_traced_run_reads_per_layer_metrics_and_restores_ops():
    from repro_torch.kernels import ops
    saved = (ops.content_hash, ops.content_hash_many, ops.boundary_bitmap)
    result, details = tiny.run("analytics.scattered-commit", trace=True)
    assert result["correct"]
    assert (ops.content_hash, ops.content_hash_many,
            ops.boundary_bitmap) == saved
    # spans and counters read on the CPU; the device trace has nothing
    # to read there, so its metrics are left out rather than zero
    assert {"put_ms.commit", "sync_ms.commit",
            "launches_per_op.commit"} <= set(result["metrics"])
    assert "hash_roofline_pct.commit" not in result["metrics"]
    assert details["kernel_bytes"]["hash"] > 0


def test_the_families_timed_steps_hold_no_planted_fault():
    """Faults are planted from outside (bench/control.py), so the timed
    path of a family or an operation has no branch for them."""
    import re
    for sub in ("families", "ops"):
        for path in (core.BENCH_DIR / sub).glob("*.py"):
            assert not re.search(r"\bfault|planted", path.read_text()), path
