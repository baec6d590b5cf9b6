"""Fixtures of the benchmark's own tests (``bench/tests``)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one (run on the "
        "card with: python -m pytest -m chip bench/tests)")


@pytest.fixture(autouse=True)
def _engine_state():
    """One torch thread a test (the suite runs under several workers), and
    the engine's global hooks as the test found them."""
    import torch

    from repro_torch.core import hashing
    from repro_torch.kernels import ops

    threads, dev = torch.get_num_threads(), ops.device()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        hashing.use_sha256()
        ops.set_device(dev)
        torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
