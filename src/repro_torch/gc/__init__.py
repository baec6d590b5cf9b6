"""Chunk garbage collection & space reclamation.

  GarbageCollector      stop-the-world mark-and-sweep over the version DAG
  IncrementalCollector  tri-color mark/sweep in budget-bounded slices,
                        safe beside live traffic (write barriers +
                        epoch root-set snapshot)
  GCPhase               the incremental state machine's phase enum
  GCReport              what one collection did (roots/live/swept/bytes)
  PinSet                explicit roots: in-flight readers, retention holds
  EpochFence            attestation/collection epoch handshake: heads
                        committed by a recent attest() stay provable
                        through the next collection

Entry points: ``ForkBase.gc()`` / ``ForkBase.incremental_gc()``
(embedded engine), ``Cluster.gc()`` / ``Cluster.incremental_gc()``
(global root set at the dispatcher, per-node sweep),
``CheckpointStore.prune`` (retention policy that drives collection),
``MemoryBackend.compact_log`` (on-disk reclamation).
"""
from .collector import (GarbageCollector, GCReport, chunk_refs,
                        expand_refs, filter_roots, mark)
from .incremental import EpochFence, GCPhase, IncrementalCollector
from .pins import PinSet

__all__ = ["EpochFence", "GarbageCollector", "GCPhase", "GCReport",
           "IncrementalCollector", "PinSet", "chunk_refs", "expand_refs",
           "filter_roots", "mark"]
