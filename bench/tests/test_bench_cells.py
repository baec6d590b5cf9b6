"""Each cell, run on the CPU at a small size: sound runs come out correct,
and a run with the timed path broken underneath (each fault a cell can
have, and the cell's control) comes out not correct."""
import pytest

from bench.harness import core
from bench.tests import tiny

CASES = tiny.cases(tiny.bench())


@pytest.mark.parametrize("cell", CASES["cells"])
def test_cell_runs_correct_on_the_cpu(cell):
    result, details = tiny.run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] == details["completed"] >= 1
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {
        m["name"] for m in core.metrics_of(tiny.bench(), cell, False)}


@pytest.mark.parametrize("cell,fault", CASES["broken"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    fault = CASES["controls"][cell][0] if fault == "control" else fault
    result, _ = tiny.run(cell, fault=fault)
    assert not result["correct"], (fault, result["checks"])
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("seed", [tiny.SEED + 1, tiny.SEED + 2,
                                  tiny.SEED + 3])
def test_a_durable_ledger_holds_its_blocks_on_three_seeds(seed):
    """The pending durable ledger cell: sound runs are correct, a block
    acknowledged without ``sync()`` is missing from the reopened engine,
    accounts whose chunks a sync left out are missing when read back, and
    a block that drops a write is caught."""
    cell = "ledger.blocks-durable"
    result, _ = tiny.run(cell, seed=seed)
    assert result["correct"], result["checks"]
    result, _ = tiny.run(cell, fault="skip_sync", seed=seed)
    assert result["checks"]["durable_mismatch"]["value"] > 0
    # the head, the state uid and the root count 3 at most: the rest is
    # the accounts read back
    result, _ = tiny.run(cell, fault="lost_leaves", seed=seed)
    assert result["checks"]["durable_mismatch"]["value"] > 3
    result, _ = tiny.run(cell, fault="drop_write", seed=seed)
    assert not result["correct"], result["checks"]


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
