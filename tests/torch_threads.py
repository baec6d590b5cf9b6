"""The autouse fixture that runs each test with one torch intra-op thread;
import it into a test module (``from torch_threads import
torch_one_thread  # noqa: F401``) to apply it there.  Not collected (no
``test_`` prefix), and it imports no JAX."""
import pytest
import torch


@pytest.fixture(autouse=True)
def torch_one_thread():
    """One intra-op thread for torch while a test runs (restored after).
    With several pytest-xdist workers and torch's default of a thread per
    core, each worker's small ops contend with every other worker's: under
    6 workers on 8 cores the model, serve and example test files took
    135.8 s with the default and 63.6 s with this fixture."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
