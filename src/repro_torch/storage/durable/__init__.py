"""Crash-durability primitives (``fsutil``).  The durable segment and
tiered stores of the reference are not ported yet."""
from __future__ import annotations

from .fsutil import fsync_dir, replace_durably, write_durably

__all__ = ["fsync_dir", "replace_durably", "write_durably"]
