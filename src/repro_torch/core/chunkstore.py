"""Content-addressed chunk storage (paper §4.4) — compatibility facade.

The implementation lives in ``storage`` behind the single
``StorageBackend`` protocol; the historical name is preserved here:

  ChunkStore      -> storage.MemoryBackend (memory + optional log file)
"""
from __future__ import annotations

from ..storage import (ChunkMissing, MemoryBackend, StorageBackend,
                       StoreStats)

ChunkStore = MemoryBackend

__all__ = ["ChunkStore", "StoreStats", "StorageBackend", "ChunkMissing"]
