"""Crash-durability primitives shared by every on-disk store.

The one sequence that makes a file replacement atomic AND durable on a
POSIX filesystem is: write the new content to a sibling temp file,
fsync the temp file, rename over the destination, then fsync the
*parent directory* — without the final dirsync a crash after the rename
can lose the new file's directory entry, resurrecting the old content
(or nothing at all).  ``MemoryBackend.compact_log`` and the segment
compactor both route through ``replace_durably``/``write_durably`` so
the sequence exists exactly once.
"""
from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry inside it survives a
    crash.  Best-effort on filesystems that refuse O_RDONLY dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def replace_durably(tmp: str, dst: str) -> None:
    """Atomically replace ``dst`` with the already-written-and-fsynced
    ``tmp``: rename + parent-dir fsync.  ``tmp`` must live in the same
    directory as ``dst`` (same-filesystem rename)."""
    os.replace(tmp, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def write_durably(dst: str, data: bytes) -> None:
    """The full write + fsync + rename + dirsync sequence for a whole
    small file (head snapshots, manifests)."""
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    replace_durably(tmp, dst)
