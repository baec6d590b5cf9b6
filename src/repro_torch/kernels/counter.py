"""Launch counts of the kernel wrappers, exact across threads.

Each wrapper calls ``LAUNCHES.bump(name)`` where it launches its kernel and
nowhere else; ``ops.launches()`` and ``ops.reset_launches()`` read and zero
the counts.  A ``+=`` on a shared int is a read-modify-write that loses
updates when threads interleave, so every update and read takes one lock.
"""
from __future__ import annotations

import threading


class LaunchCounter:
    """Counts by name under one lock."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def bump(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(self._counts, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchCounter(("boundary_bitmap", "fphash_many", "fphash"))
