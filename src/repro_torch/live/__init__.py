"""Live/Archive split (forkless flat-state fast path).

  LiveTable    flat dict-of-key->value head state: O(1) get/put, backed
               by the POS-Tree archive for history, forks and proofs
  EpochPolicy  dirty-key/byte thresholds that trigger automatic folds
  FoldReport   what one epoch fold committed
  EpochReport  what one ForkBase.commit_epoch() did engine-wide
  LiveStats    flat-path counters (hits/misses/folds/fold cost)

Entry points: ``ForkBase.live(key, branch)`` / ``ForkBase.commit_epoch()``
(embedded engine).  The cluster's routed ``Cluster.live`` /
``Cluster.commit_epoch()`` come with the cluster slice of the port.
"""
from .table import (EpochPolicy, EpochReport, FoldReport, LiveStats,
                    LiveTable)

__all__ = ["EpochPolicy", "EpochReport", "FoldReport", "LiveStats",
           "LiveTable"]
