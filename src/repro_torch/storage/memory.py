"""In-memory content-addressed backend with optional append-only log
(paper §4.4).  This is the leaf store every composite backend (cache,
replication, sharding, routing) eventually bottoms out in.

The log is a record stream ``cid | u32 len | payload``; a delete appends
a *tombstone* record (``len == 0xFFFFFFFF``, no payload), so replay of an
uncompacted log converges to the live set and a crash between a GC sweep
and compaction cannot resurrect dead chunks.  ``compact_log`` rewrites
only the live chunks to a fresh file and atomically replaces the old one
(the space-reclamation half of the GC subsystem)."""
from __future__ import annotations

import os
import struct

from ..obs import emit as obs_emit
from .backend import (BackendBase, ChunkMissing, TamperedChunk,
                      check_chunk, resolve_cids)
from .durable.fsutil import replace_durably

_LEN = struct.Struct("<I")
_TOMBSTONE = 0xFFFFFFFF

# cid_of lives in the core package, which imports storage back through
# the chunkstore facade — a module-scope import would cycle, so the
# binding is resolved once on first use and cached here instead of being
# re-imported on every put_many/get_many/_replay call
_cid_of = None


def _chunk_cid_of():
    global _cid_of
    if _cid_of is None:
        from ..core.chunk import cid_of
        _cid_of = cid_of
    return _cid_of


class MemoryBackend(BackendBase):
    """dict-backed store; with ``log_path`` every new chunk is appended to
    a log-structured file and replayed on open (torn tails recovered,
    tombstones applied; with ``verify=True`` every replayed chunk is
    re-hashed and tampering raises TamperedChunk)."""

    OBS_NAME = "memory"

    def __init__(self, log_path: str | None = None, verify: bool = False):
        super().__init__()
        self._data: dict[bytes, bytes] = {}
        self.verify = verify
        self._log_path = log_path
        self._log = None
        if log_path:
            # replay (truncating any torn tail) BEFORE opening for
            # append, so post-crash records land at a parseable offset
            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                self._replay(log_path)
            self._log = open(log_path, "ab")

    # ------------------------------------------------------------ batched
    def _put_many_impl(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        provided = ([] if cids is None else
                    [i for i, c in enumerate(cids) if c is not None])
        out = resolve_cids(raws, cids)
        if self.verify and provided:
            # only caller-supplied cids can mismatch; self-computed ones
            # would just re-hash the same bytes
            cid_of = _chunk_cid_of()
            for i in provided:
                if not check_chunk(self.stats, cid_of, raws[i], out[i]):
                    raise TamperedChunk(out[i], "Put-Chunk")
        st = self.stats
        st.put_batches += 1
        for raw, cid in zip(raws, out):
            st.puts += 1
            st.logical_bytes += len(raw)
            if cid in self._data:
                st.dedup_hits += 1     # immediate ack, chunk reused (§4.4)
                continue
            self._data[cid] = raw
            st.physical_bytes += len(raw)
            if self._log is not None:
                self._log.write(cid + _LEN.pack(len(raw)) + raw)
        self._notify_put(out)
        return out

    def _get_many_impl(self, cids) -> list[bytes]:
        st = self.stats
        st.get_batches += 1
        cid_of = _chunk_cid_of() if self.verify else None
        out = []
        for cid in cids:
            st.gets += 1
            raw = self._data.get(cid)
            if raw is None:
                raise ChunkMissing(cid)
            if self.verify and not check_chunk(st, cid_of, raw, cid):
                raise TamperedChunk(cid, "Get-Chunk")
            out.append(raw)
        return out

    def has_many(self, cids) -> list[bool]:
        return [cid in self._data for cid in cids]

    def _delete_many_impl(self, cids) -> int:
        st = self.stats
        n = 0
        for cid in cids:
            raw = self._data.pop(cid, None)
            if raw is None:
                continue               # absent cids are a no-op
            n += 1
            st.deletes += 1
            st.physical_bytes -= len(raw)
            st.reclaimed_bytes += len(raw)
            if self._log is not None:
                self._log.write(cid + _LEN.pack(_TOMBSTONE))
        return n

    def iter_cids(self):
        return iter(list(self._data))

    def __len__(self) -> int:
        return len(self._data)

    def flush(self) -> None:
        if self._log is not None:
            self._log.flush()
            os.fsync(self._log.fileno())

    # ---------------------------------------------------------------- log
    def _replay(self, path: str) -> None:
        """Rebuild ``_data`` AND the replay-recoverable StoreStats from
        the record stream.  Every chunk record restores ``puts`` /
        ``logical_bytes`` (the log only ever holds first-time puts, so
        a record is exactly one counted put) and every tombstone counts
        in ``deletes`` / ``reclaimed_bytes`` — without this, dedup and
        space ratios are wrong after every reopen (puts/logical reset
        to zero, deletes invisible)."""
        cid_of = _chunk_cid_of()
        from ..core.hashing import CID_LEN
        st = self.stats
        good = 0                       # offset after the last whole record
        with open(path, "rb") as f:
            while True:
                head = f.read(CID_LEN + 4)
                if len(head) < CID_LEN + 4:
                    break
                cid = head[:CID_LEN]
                (ln,) = _LEN.unpack(head[CID_LEN:])
                if ln == _TOMBSTONE:   # deleted later in the stream
                    old = self._data.pop(cid, None)
                    if old is not None:
                        st.physical_bytes -= len(old)
                        st.deletes += 1
                        st.reclaimed_bytes += len(old)
                    good = f.tell()
                    continue
                raw = f.read(ln)
                if len(raw) < ln:
                    break  # torn tail write: recover prefix
                if self.verify and not check_chunk(st, cid_of, raw, cid):
                    raise TamperedChunk(cid, "log replay")
                st.puts += 1
                st.logical_bytes += ln
                if cid not in self._data:
                    st.physical_bytes += ln
                self._data[cid] = raw
                good = f.tell()
        size = os.path.getsize(path)
        if good < size:
            # drop the torn tail ON DISK too: appending after unparseable
            # bytes would corrupt every later record (replay would read
            # them as the torn record's payload — tombstones and new
            # chunks silently lost)
            os.truncate(path, good)
            obs_emit("storage.torn_tail", backend="memory", path=path,
                     dropped_bytes=size - good, offset=good)

    def log_size(self) -> int:
        """Current on-disk log size in bytes (0 without a log)."""
        if self._log is None:
            return 0
        self._log.flush()
        return os.path.getsize(self._log_path)

    def compact_log(self) -> tuple[int, int]:
        """Rewrite the log with only the live chunks — dead records and
        tombstones drop out — then atomically replace it (write + fsync +
        rename + parent-dir fsync via ``replace_durably``; without the
        dirsync a crash after the rename could lose the new file's
        directory entry).  Returns (bytes_before, bytes_after)."""
        if self._log is None:
            return (0, 0)
        before = self.log_size()
        tmp = self._log_path + ".compact"
        with open(tmp, "wb") as f:
            for cid, raw in self._data.items():
                f.write(cid + _LEN.pack(len(raw)) + raw)
            f.flush()
            os.fsync(f.fileno())
        self._log.close()
        replace_durably(tmp, self._log_path)
        self._log = open(self._log_path, "ab")
        return before, os.path.getsize(self._log_path)
