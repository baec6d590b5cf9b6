"""Content-addressed chunk storage (paper §4.4) — compatibility facade.

The implementations live in ``storage`` behind the single
``StorageBackend`` protocol; the historical names are preserved here:

  ChunkStore      -> storage.MemoryBackend (memory + optional log file)
  ReplicatedStore -> storage.ReplicatedBackend
"""
from __future__ import annotations

from ..storage import (ChunkMissing, MemoryBackend, ReplicatedBackend,
                       StorageBackend, StoreStats)

ChunkStore = MemoryBackend
ReplicatedStore = ReplicatedBackend

__all__ = ["ChunkStore", "ReplicatedStore", "StoreStats", "StorageBackend",
           "ChunkMissing"]
