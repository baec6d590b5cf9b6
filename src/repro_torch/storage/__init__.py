"""Unified storage-backend layer (paper §4.4, §4.6).

One protocol — ``StorageBackend`` — with a batched core surface
(``put_many`` / ``get_many`` / ``has_many`` + stats), and composable
implementations:

  MemoryBackend     in-memory dict, optional log-structured file
  SegmentBackend    durable log-structured segment files (storage.durable)
  TieredBackend     memory hot tier + durable cold tier (storage.durable)
  LRUCacheBackend   LRU read cache over any backend
  ReplicatedBackend k-way replication with read failover
  ShardedBackend    cid-hash partitioning across in-process shards
  WriteBuffer       write-behind batch: one put_many per value commit

The reference's ``cluster._RoutingStore`` (meta-pinned two-layer
partitioning) lives with the cluster, which is not ported yet.

Select or stack backends with ``make_backend``:

    make_backend("memory")
    make_backend("log", log_path="/tmp/chunks.log")
    make_backend("lru+sharded", shards=8)          # cache over shards
    make_backend("replicated", n=4, k=2)
    make_backend("segment", root="/data/chunks")   # durable segments
    make_backend("tiered", root="/data/chunks")    # hot tier over them
"""
from __future__ import annotations

from ..errors import ConfigError
from .backend import (BackendBase, ChunkMissing, StorageBackend, StoreStats,
                      TamperedChunk, resolve_cids)
from .buffer import WriteBuffer
from .cache import LRUCacheBackend
from .durable import SegmentBackend, TieredBackend, open_durable
from .memory import MemoryBackend
from .replicated import ReplicatedBackend
from .sharded import ShardedBackend

__all__ = [
    "StorageBackend", "BackendBase", "StoreStats", "ChunkMissing",
    "TamperedChunk", "MemoryBackend", "LRUCacheBackend",
    "ReplicatedBackend", "ShardedBackend", "SegmentBackend",
    "TieredBackend", "WriteBuffer", "make_backend", "open_durable",
    "resolve_cids",
]


def make_backend(spec: str = "memory", *, log_path: str | None = None,
                 root: str | None = None, n: int = 4, k: int = 2,
                 shards: int = 4, capacity_bytes: int = 64 << 20,
                 segment_bytes: int = 4 << 20, verify: bool = False):
    """Build a backend from a ``+``-separated layer spec, outermost first.

    Base layers: ``memory`` | ``log`` (requires log_path) | ``segment``
    / ``tiered`` (require root) | ``sharded`` | ``replicated``.
    Wrapper layers: ``lru``.  A malformed spec raises ``ConfigError``
    (a ``ValueError``).
    """
    layers = spec.split("+")
    base = layers[-1]
    if base == "memory":
        backend = MemoryBackend(verify=verify)
    elif base == "log":
        if not log_path:       # must survive -O: silent memory fallback
            raise ConfigError("log backend needs log_path")
        backend = MemoryBackend(log_path=log_path, verify=verify)
    elif base in ("segment", "tiered"):
        if not root:
            raise ConfigError(f"{base} backend needs root")
        if base == "segment":
            backend = SegmentBackend(root, segment_bytes=segment_bytes,
                                     verify=verify)
        else:
            backend = open_durable(root, hot_bytes=capacity_bytes,
                                   segment_bytes=segment_bytes,
                                   verify=verify)
    elif base == "sharded":
        backend = ShardedBackend(
            shards, factory=lambda: MemoryBackend(verify=verify))
    elif base == "replicated":
        backend = ReplicatedBackend([MemoryBackend(verify=verify)
                                     for _ in range(n)], k=k)
    else:
        raise ConfigError(f"unknown base backend: {base!r}")
    for layer in reversed(layers[:-1]):
        if layer == "lru":
            backend = LRUCacheBackend(backend, capacity_bytes=capacity_bytes,
                                      verify=verify)
        else:
            raise ConfigError(f"unknown wrapper layer: {layer!r}")
    return backend
