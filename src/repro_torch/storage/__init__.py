"""Unified storage-backend layer (paper §4.4, §4.6).

One protocol — ``StorageBackend`` — with a batched core surface
(``put_many`` / ``get_many`` / ``has_many`` + stats).  Ported so far:

  MemoryBackend     in-memory dict, optional log-structured file
  WriteBuffer       write-behind batch: one put_many per value commit

Select a backend with ``make_backend``:

    make_backend("memory")
    make_backend("log", log_path="/tmp/chunks.log")

The reference's segment, tiered, LRU, replicated and sharded stores come
with later slices of the port; their specs raise ``ConfigError``.
"""
from __future__ import annotations

from ..errors import ConfigError
from .backend import (BackendBase, ChunkMissing, StorageBackend, StoreStats,
                      TamperedChunk, resolve_cids)
from .buffer import WriteBuffer
from .memory import MemoryBackend

__all__ = [
    "StorageBackend", "BackendBase", "StoreStats", "ChunkMissing",
    "TamperedChunk", "MemoryBackend", "WriteBuffer", "make_backend",
    "resolve_cids",
]

_NOT_PORTED = ("segment", "tiered", "sharded", "replicated", "lru")


def make_backend(spec: str = "memory", *, log_path: str | None = None,
                 verify: bool = False):
    """Build a backend from a spec: ``memory`` | ``log`` (requires
    log_path)."""
    if spec == "memory":
        return MemoryBackend(verify=verify)
    if spec == "log":
        if not log_path:       # must survive -O: silent memory fallback
            raise ConfigError("log backend needs log_path")
        return MemoryBackend(log_path=log_path, verify=verify)
    if any(layer in _NOT_PORTED for layer in spec.split("+")):
        raise ConfigError(f"backend spec {spec!r} is not ported yet")
    raise ConfigError(f"unknown backend spec: {spec!r}")
