"""fphash, the 256-bit content hash of the dedup path: the wrappers of the
CUDA kernels in ``csrc/fphash.cu``, which replace the Pallas TPU kernels
``repro/kernels/fphash.py::_fphash_many_kernel`` (batched) and
``::_fphash_kernel`` (one string).

A digest is 8 u32 words, returned as int32 tensors with the same bits
(``ops`` turns them into the 32-byte little-endian cids).  On CUDA
tensors the wrappers launch the kernels on the current stream (or raise);
on CPU tensors they run the plain PyTorch versions of ``ref.py``.
"""
from __future__ import annotations

import torch

from ..errors import ConfigError
from . import build, ref


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ConfigError("fphash inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ConfigError(f"no fphash kernel for device {dev}")
    return dev


def _bytes_1d(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ConfigError(f"fphash takes a 1-D uint8 tensor, got "
                          f"{data.dtype} of shape {tuple(data.shape)}")


def fphash_many(data: torch.Tensor, offsets: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Digests of a ragged batch in ONE launch: chunk i is
    ``data[offsets[i] : offsets[i] + lengths[i]]``.  Returns int32 (n, 8)."""
    _bytes_1d(data)
    if (offsets.dtype != torch.int64 or lengths.dtype != torch.int64
            or offsets.shape != lengths.shape or offsets.dim() != 1):
        raise ConfigError("offsets and lengths must be 1-D int64 of one shape")
    dev = _device_of(data, offsets, lengths)
    n = lengths.numel()
    if n:
        lo_len, lo_off, hi_end = torch.stack(
            [lengths.min(), offsets.min(), (offsets + lengths).max()]).tolist()
        if lo_len < 0 or lo_off < 0 or hi_end > data.numel():
            raise ConfigError("a chunk lies outside the data buffer")
    if dev.type == "cpu":
        return ref.fphash_many_ref(data, offsets, lengths)
    data, offsets, lengths = (data.contiguous(), offsets.contiguous(),
                              lengths.contiguous())
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n:
        fn = build.lib("fphash").fphash_many_cuda
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(data.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
                     n, out.data_ptr(), stream)
        build.check(err, "fphash_many_cuda")
        fphash_many.launches += 1
    return out


def fphash(data: torch.Tensor) -> torch.Tensor:
    """Digest of one byte string.  Returns int32 (8,)."""
    _bytes_1d(data)
    dev = _device_of(data)
    if dev.type == "cpu":
        return ref.fphash_ref(data)
    data = data.contiguous()
    out = torch.empty(8, dtype=torch.int32, device=dev)
    fn = build.lib("fphash").fphash_one_cuda
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), data.numel(), out.data_ptr(), stream)
    build.check(err, "fphash_one_cuda")
    fphash.launches += 1
    return out


fphash_many.launches = 0
fphash.launches = 0
