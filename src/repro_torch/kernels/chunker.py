"""Rolling-hash boundary bitmap: the wrapper of the CUDA kernel
``csrc/chunker.cu``, which replaces the Pallas TPU kernel
``repro/kernels/chunker.py::_chunker_kernel``.

``boundary_bitmap`` takes a uint8 tensor.  On a CUDA tensor it launches the
kernel on the current stream (or raises); on a CPU tensor it runs the plain
PyTorch version, ``core.rolling.boundary_bitmap``.  The result is a bool
tensor on the input's device, bit-identical to the plain version.
"""
from __future__ import annotations

import torch

from ..core import rolling
from ..errors import ConfigError
from . import build

MAX_WINDOW = 128        # the kernel stages the 128 bytes before each tile


def _check(data: torch.Tensor, window: int, q: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ConfigError(f"boundary_bitmap takes a 1-D uint8 tensor, got "
                          f"{data.dtype} of shape {tuple(data.shape)}")
    if not 1 <= window <= MAX_WINDOW:
        raise ConfigError(f"window {window} outside the kernel's "
                          f"1..{MAX_WINDOW}")
    if not 0 <= q <= 32:
        raise ConfigError(f"pattern bits q={q} outside 0..32")


def boundary_bitmap(data: torch.Tensor, window: int = 48, q: int = 12,
                    seed: int = rolling.SEED) -> torch.Tensor:
    """bool[n]: True at i iff the rolling hash over the window ending at i
    has its low q bits zero; the first window-1 positions are False."""
    _check(data, window, q)
    if data.device.type == "cpu":
        return rolling.boundary_bitmap(data, window, q, seed)
    if data.device.type != "cuda":
        raise ConfigError(f"no boundary kernel for device {data.device}")
    data = data.contiguous()
    out = torch.empty(data.numel(), dtype=torch.uint8, device=data.device)
    if data.numel():
        fn = build.lib("chunker").boundary_bitmap_cuda
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(data.data_ptr(), data.numel(), out.data_ptr(), window,
                     (1 << q) - 1, (seed * rolling.GOLD) & rolling.MASK32,
                     stream)
        build.check(err, "boundary_bitmap_cuda")
        boundary_bitmap.launches += 1
    return out.view(torch.bool)


boundary_bitmap.launches = 0
