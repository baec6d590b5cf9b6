"""fphash, the 256-bit content hash of the dedup path: the wrappers of the
CUDA kernels in ``csrc/fphash.cu``, which replace the Pallas TPU kernels
``repro/kernels/fphash.py::_fphash_many_kernel`` (batched) and
``::_fphash_kernel`` (one string).

A digest is 8 u32 words, returned as int32 tensors with the same bits
(``ops`` turns them into the 32-byte little-endian cids).  On CUDA
tensors the wrappers launch the kernels on the current stream (or raise);
on CPU tensors they run the plain PyTorch versions of ``ref.py``.

``fphash_host`` is the engine's route for one value on the host: the
kernel reads the value from the calling thread's pinned staging buffer
and writes the digest back to pinned memory, so a call is one host copy,
one launch and one wait for the stream.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..errors import ConfigError
from . import build, ref
from .counter import LAUNCHES

# first capacity of a thread's input staging, which grows by doubling: the
# largest chunk the engine makes is 8 x 4 KB + the type byte
STAGING_BYTES = 64 << 10
DIGEST_BYTES = 32


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
        LAUNCHES.bump("fphash_many")
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
    LAUNCHES.bump("fphash")
    return out


def _pin(nbytes: int) -> torch.Tensor:
    """A pinned host buffer from torch's caching host allocator."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class _Staging:
    """One host thread's pinned buffers for one device: the input, grown
    by doubling, and the 32-byte digest, each kept with its device view
    (asked of the driver once per buffer)."""

    def __init__(self, index: int):
        self.index = index
        self.lib = build.lib("fphash")
        self.out, self.out_view = self._map(DIGEST_BYTES)
        self.out_host = memoryview(self.out.numpy())
        self.cap = 0
        self.reserve(STAGING_BYTES)

    def _map(self, nbytes: int) -> tuple[torch.Tensor, int]:
        buf = _pin(nbytes)
        view = ctypes.c_void_p()
        build.check(self.lib.fphash_host_map(buf.data_ptr(), self.index,
                                             ctypes.byref(view)),
                    "fphash_host_map")
        return buf, view.value

    def reserve(self, nbytes: int) -> None:
        if nbytes > self.cap:
            cap = max(self.cap, STAGING_BYTES)
            while cap < nbytes:
                cap *= 2
            self.buf, self.buf_view = self._map(cap)
            self.buf_host = memoryview(self.buf.numpy())
            self.cap = cap


_local = threading.local()


def _staging(index: int) -> _Staging:
    by_device = getattr(_local, "by_device", None)
    if by_device is None:
        by_device = _local.by_device = {}
    st = by_device.get(index)
    if st is None:
        st = by_device[index] = _Staging(index)
    return st


def fphash_host(data, device: torch.device) -> bytes:
    """The 32-byte cid of one byte string on the host (bytes, bytearray,
    memoryview) by the kernel on CUDA ``device``: the bytes are copied into
    the calling thread's pinned staging, the kernel reads them there and
    writes the digest back there, and the call waits for the current stream
    of ``device``."""
    src = memoryview(data).cast("B")
    n = src.nbytes
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    st = _staging(index)
    st.reserve(n)
    st.buf_host[:n] = src
    # the current stream's handle as Triton's launcher reads it:
    # torch.cuda.current_stream() builds a Stream object, several times
    # the cost of the handle alone
    stream = torch._C._cuda_getCurrentRawStream(index)
    build.check(st.lib.fphash_host_cuda(st.buf_view, n, st.out_view, index,
                                        stream), "fphash_host_cuda")
    cid = bytes(st.out_host)
    LAUNCHES.bump("fphash")
    return cid
