"""Durable tiered storage: log-structured segments + hot/cold tiering.

``open_durable(root)`` is the one-call production stack — a memory hot
tier over a segment-file cold tier rooted at ``root/segments`` — used
by ``ForkBase(durable_root=...)`` and ``Cluster(durable_root=...)``.
"""
from __future__ import annotations

import os

from .fsutil import fsync_dir, replace_durably, write_durably
from .segment import FOOTER_CID, SegmentBackend
from .tiered import TieredBackend

__all__ = [
    "SegmentBackend", "TieredBackend", "open_durable",
    "fsync_dir", "replace_durably", "write_durably", "FOOTER_CID",
]


def open_durable(root: str, *, hot_bytes: int = 64 << 20,
                 segment_bytes: int = 4 << 20, compact_ratio: float = 0.5,
                 verify: bool = False) -> TieredBackend:
    """Open (or create) the durable tiered stack under ``root``."""
    os.makedirs(root, exist_ok=True)
    cold = SegmentBackend(os.path.join(root, "segments"),
                          segment_bytes=segment_bytes,
                          compact_ratio=compact_ratio, verify=verify)
    return TieredBackend(cold, hot_bytes=hot_bytes, verify=verify)
