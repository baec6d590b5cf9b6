"""The cells on the card at small sizes: sound runs come out correct and
each cell's control does not.  Skips without a CUDA card; on the card:
``python -m pytest -m chip bench/tests``.  The controls at the cells' own
sizes run with ``bench/control.py``."""
import pytest

from bench.tests import tiny
from bench.tests.test_bench_cells import CELLS, CONTROLS


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_its_control_on_the_card(card, cell):
    from bench.harness.runner import run_cell
    for fault, want in ((None, True),
                        *((c, False) for c in CONTROLS[cell])):
        result, _ = run_cell(cell, tiny.SEED, 1.0, False, device=card,
                             bench=tiny.bench(), config=tiny.config_of(cell),
                             traffic=tiny.traffic_of(cell),
                             plant=fault and tiny.planted(cell, fault))
        assert result["correct"] is want, (fault, result["checks"])
        assert result["device"]["platform"] == "gpu"
