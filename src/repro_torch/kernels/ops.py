"""The engine's device and its host-side glue to the kernels.

The storage engine keeps its data on the host (numpy arrays, ``bytes``);
this module moves what a kernel reads onto the engine's device, calls the
kernel's wrapper, and brings back only what the engine needs.  The device
defaults to CUDA; ``set_device("cpu")`` selects the CPU, where every
wrapper runs its plain PyTorch version.  A CUDA device without a GPU raises
rather than falling back to the CPU.

Engine hooks (the counterparts of ``repro.kernels.ops``):

  * ``core.chunker`` calls ``boundary_bitmap`` by default;
    ``use_kernel_chunker(False)`` swaps in the plain version on the device;
  * ``use_kernel_hash()`` (that is, ``core.hashing.use_fphash()``) routes
    cids through ``content_hash`` (one ``fphash_host`` launch, zero-copy
    from pinned host memory) / ``content_hash_many`` (one ``fphash_many``
    launch per batch); ``use_kernel_hash(False)`` restores sha256.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..errors import ConfigError
from . import chunker as _kchunker
from . import fphash as _kfphash
from .counter import LAUNCHES
from .ref import boundary_bitmap_ref, fphash_ref

_DEVICE = torch.device("cuda")


def set_device(dev) -> None:
    """Select the engine's device ("cuda", "cuda:1", "cpu")."""
    global _DEVICE
    dev = torch.device(dev)
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported engine device {dev}")
    _DEVICE = dev


def device() -> torch.device:
    return _DEVICE


def ready_device() -> torch.device:
    """The engine's device, after checking that it exists: a CUDA device
    without a GPU raises ConfigError rather than falling back to the
    CPU."""
    if _DEVICE.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError("engine device is CUDA but no GPU is available; "
                          "call kernels.ops.set_device('cpu') for the CPU")
    return _DEVICE


def to_device(data) -> torch.Tensor:
    """A host byte stream (numpy uint8 array, bytes) as a uint8 tensor on
    the engine's device."""
    dev = ready_device()
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    with warnings.catch_warnings():
        # a view of immutable bytes: the tensor is only ever read
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(data)
    return host.to(dev)


# ---------------------------------------------------------------- chunker

def boundary_bitmap(data, window: int = 48, q: int = 12) -> torch.Tensor:
    """Boundary bitmap of a host stream by the CUDA kernel on the engine's
    device (bool tensor there)."""
    return _kchunker.boundary_bitmap(to_device(data), window, q)


def plain_boundary_bitmap(data, window: int = 48, q: int = 12) -> torch.Tensor:
    """The same bitmap by the plain PyTorch version on the engine's
    device."""
    return boundary_bitmap_ref(to_device(data), window, q)


def use_kernel_chunker(enable: bool = True) -> None:
    from ..core import chunker
    chunker.set_bitmap_impl(boundary_bitmap if enable
                            else plain_boundary_bitmap)


# ----------------------------------------------------------------- fphash

def _digest_bytes(digests: torch.Tensor) -> list[bytes]:
    """int32 (n, 8) digests -> 32-byte cids (u32 words, little-endian)."""
    raw = digests.cpu().numpy().astype("<i4").tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def hash_many_with(fn, blobs) -> list[bytes]:
    """cids of a batch of byte strings by ``fn`` (``fphash_many`` or its
    plain version): the batch crosses to the device as one concatenated
    buffer with int64 offsets and lengths."""
    if not blobs:
        return []
    lengths = np.fromiter(map(len, blobs), dtype=np.int64, count=len(blobs))
    offsets = np.zeros_like(lengths)
    np.cumsum(lengths[:-1], out=offsets[1:])
    data = to_device(b"".join(blobs))
    return _digest_bytes(fn(data, torch.from_numpy(offsets).to(_DEVICE),
                            torch.from_numpy(lengths).to(_DEVICE)))


def content_hash(data) -> bytes:
    """fphash cid of one host byte string: on a CUDA engine device by the
    kernel reading it from pinned host memory (``fphash_host``), on the
    CPU by the plain version."""
    dev = ready_device()
    if dev.type == "cuda":
        return _kfphash.fphash_host(data, dev)
    return _digest_bytes(fphash_ref(to_device(data))[None])[0]


def content_hash_many(blobs) -> list[bytes]:
    """fphash cids of a batch in one ``fphash_many`` launch."""
    return hash_many_with(_kfphash.fphash_many, [bytes(b) for b in blobs])


def use_kernel_hash(enable: bool = True) -> None:
    """Delegates to hashing.use_fphash/use_sha256, so the batched entry
    point (one ``fphash_many`` launch per batch) switches together with the
    singular one."""
    from ..core import hashing
    if enable:
        hashing.use_fphash()
    else:
        hashing.use_sha256()


def reset_launches() -> None:
    """Zero the launch counter of every kernel wrapper."""
    LAUNCHES.reset()


def launches() -> dict[str, int]:
    """Launch count of every kernel wrapper since the last reset."""
    return LAUNCHES.snapshot()


__all__ = ["boundary_bitmap", "content_hash", "use_kernel_chunker",
           "use_kernel_hash", "boundary_bitmap_ref", "fphash_ref"]
