"""Live/Archive split (forkless flat-state fast path).

  LiveTable    flat dict-of-key->value head state: O(1) get/put, backed
               by the POS-Tree archive for history, forks and proofs
  EpochPolicy  dirty-key/byte thresholds that trigger automatic folds
  FoldReport   what one epoch fold committed
  EpochReport  what one ForkBase.commit_epoch() did engine-wide
  LiveStats    flat-path counters (hits/misses/folds/fold cost)

Entry points: ``ForkBase.live(key, branch)`` / ``ForkBase.commit_epoch()``
(embedded engine), ``Cluster.live(key, branch)`` / ``Cluster.commit_epoch()``
(routed per servlet).
"""
from .table import (EpochPolicy, EpochReport, FoldReport, LiveStats,
                    LiveTable)

__all__ = ["EpochPolicy", "EpochReport", "FoldReport", "LiveStats",
           "LiveTable"]
