"""Disk-backed log-structured segment store — the durable leaf backend
(UStore/ForkBase production shape).

Chunks are appended to bounded *segment files* named ``seg-<gen>.seg``:

  record     cid(32) | u32 len | payload          (same framing as the
  tombstone  cid(32) | u32 0xFFFFFFFF             MemoryBackend log)
  footer     FOOTER_CID(32) | u32 plen | plen bytes:
                 u64 generation | u32 count | count * (u64 off|u32 len|cid)
  trailer    u64 footer_offset | b"SEGTRLR1"      (last 16 bytes)

The *active* segment takes appends; when it crosses ``segment_bytes``
it is sealed — footer + trailer written and fsynced — and a new
generation starts.  On open the in-memory ``cid -> (segment, offset,
len)`` index is rebuilt from footers alone (no payload reads); the
active segment has no footer yet and falls back to a record scan that
truncates any torn tail, exactly like the MemoryBackend log replay.
Replay also restores the replay-recoverable StoreStats, so dedup and
space ratios survive a reopen (delete counters are recovered only while
the dead records still exist on disk — compaction removes the evidence
together with the bytes, exactly like ``compact_log``).

Deletes (the GC sweep verb) append a tombstone to the active segment
and account the dead record's bytes against the segment that holds it.
Sealed segments whose dead ratio crosses ``compact_ratio`` are
rewritten live-chunks-only by ``compact()`` and atomically swapped in
(write + fsync + rename + parent-dir fsync via ``fsutil``) — per
segment, not the all-or-nothing ``compact_log`` rewrite.  ``flush()``
runs eligible compactions by default, so the GC sweep's post-delete
flush *is* the compaction feed.  A tombstone survives its segment's
rewrite only while an earlier segment still holds a (dead) record for
its cid — dropping it sooner would resurrect that record on replay.

``iter_cids`` streams the live cids one segment at a time, so the
incremental-GC inventory freeze never materializes one store-wide
pointer copy.

Reads of a sealed segment copy records out of a read-only map of its
file; the active segment is read with ``pread`` after its buffered
appends are flushed.
"""
from __future__ import annotations

import mmap
import os
import struct

from ...errors import ConfigError
from ...obs import emit as obs_emit
from ...obs import trace as obs_trace
from ..backend import BackendBase, ChunkMissing, check_chunks, resolve_cids
from .fsutil import fsync_dir, replace_durably

_CID = 32
_LEN = struct.Struct("<I")
_HEAD = _CID + _LEN.size                 # bytes before a record's payload
_TOMBSTONE = 0xFFFFFFFF

FOOTER_CID = b"\xffSEGFOOT" * 4          # 32 bytes; collides with a real
#   cid with probability 2^-256 — the footer pseudo-record is framed
#   exactly like a chunk so a plain record scan steps over it safely
_FOOT_HEAD = struct.Struct("<QI")        # generation, entry count
_FOOT_ENTRY = struct.Struct("<QI32s")    # record offset, len, cid
_TRAILER = struct.Struct("<Q8s")         # footer record offset, magic
_TRAILER_MAGIC = b"SEGTRLR1"

class _Segment:
    """In-memory face of one segment file."""

    __slots__ = ("gen", "path", "live", "dead", "tombs", "records",
                 "data_bytes", "dead_bytes", "size", "sealed")

    def __init__(self, gen: int, path: str):
        self.gen = gen
        self.path = path
        self.live: dict[bytes, tuple[int, int]] = {}  # cid -> (payload off, len)
        self.dead: dict[bytes, int] = {}     # cid -> dead record payload bytes
        self.tombs: set[bytes] = set()       # cids tombstoned IN this segment
        # append-ordered (record offset, len|TOMBSTONE, cid) — the future
        # footer; kept for the active segment only (None once sealed)
        self.records: list[tuple[int, int, bytes]] | None = []
        self.data_bytes = 0                  # payload bytes of all chunk records
        self.dead_bytes = 0                  # payload bytes of dead records
        self.size = 0                        # file bytes (records + footer)
        self.sealed = False

    @property
    def dead_ratio(self) -> float:
        return self.dead_bytes / max(1, self.data_bytes)


def _pack_footer(gen: int, records) -> bytes:
    body = _FOOT_HEAD.pack(gen, len(records)) + b"".join(
        _FOOT_ENTRY.pack(off, ln, cid) for off, ln, cid in records)
    return FOOTER_CID + _LEN.pack(len(body)) + body


class SegmentBackend(BackendBase):
    OBS_NAME = "segment"
    """Durable log-structured StorageBackend over a directory of bounded
    segment files.  Conforms to the full protocol (batched verbs, put
    listeners, streamed ``iter_cids``) so it slots under the cache /
    replication / sharding / cluster-routing layers and the GC, proof
    and live subsystems unchanged."""

    def __init__(self, root: str, *, segment_bytes: int = 4 << 20,
                 compact_ratio: float = 0.5, auto_compact: bool = True,
                 verify: bool = False):
        super().__init__()
        self.root = root
        self.segment_bytes = segment_bytes
        self.compact_ratio = compact_ratio
        self.auto_compact = auto_compact
        self.verify = verify
        self._segments: dict[int, _Segment] = {}
        self._index: dict[bytes, int] = {}   # cid -> owning generation
        self._rfds: dict[int, int] = {}      # per-segment O_RDONLY fds
        self._maps: dict[int, mmap.mmap] = {}  # sealed segments, read-only
        self._active: _Segment | None = None
        self._wf = None                      # active append handle
        os.makedirs(root, exist_ok=True)
        self._open_all()

    # ------------------------------------------------------------- open
    def _path(self, gen: int) -> str:
        return os.path.join(self.root, f"seg-{gen:08d}.seg")

    def _open_all(self) -> None:
        gens = sorted(
            int(name[4:-4]) for name in os.listdir(self.root)
            if name.startswith("seg-") and name.endswith(".seg"))
        for gen in gens:
            path = self._path(gen)
            entries = self._load_footer(path)
            if entries is None:
                entries = self._scan(path)   # active / torn / footerless
                sealed = gen != gens[-1]     # only the newest may append
            else:
                sealed = True
            seg = _Segment(gen, path)
            seg.size = os.path.getsize(path)
            seg.sealed = sealed
            seg.records = None if sealed else list(entries)
            self._segments[gen] = seg
            self._apply(seg, entries)
            if not sealed:
                self._active = seg
        if self._active is None:
            self._roll(gens[-1] + 1 if gens else 1)
        else:
            self._wf = open(self._active.path, "ab")

    def _apply(self, seg: _Segment, entries) -> None:
        """Replay one segment's records into the global index and the
        replay-recoverable stats (replay == re-execution, like the
        MemoryBackend log)."""
        st = self.stats
        for off, ln, cid in entries:
            if ln == _TOMBSTONE:
                seg.tombs.add(cid)
                owner = self._index.pop(cid, None)
                if owner is not None:
                    oseg = self._segments[owner]
                    _, oln = oseg.live.pop(cid)
                    oseg.dead[cid] = oseg.dead.get(cid, 0) + oln
                    oseg.dead_bytes += oln
                    st.deletes += 1
                    st.physical_bytes -= oln
                    st.reclaimed_bytes += oln
                continue
            st.puts += 1
            st.logical_bytes += ln
            owner = self._index.get(cid)
            if owner is not None:            # duplicate record: old dies
                oseg = self._segments[owner]
                _, oln = oseg.live.pop(cid)
                oseg.dead[cid] = oseg.dead.get(cid, 0) + oln
                oseg.dead_bytes += oln
                st.physical_bytes -= oln
            seg.live[cid] = (off + _HEAD, ln)
            seg.data_bytes += ln
            st.physical_bytes += ln
            self._index[cid] = seg.gen

    def _load_footer(self, path: str):
        """Footer-indexed open: no payload reads.  Returns the ordered
        record entries, or None when the footer is absent/torn (fall
        back to a scan)."""
        try:
            size = os.path.getsize(path)
            if size < _TRAILER.size:
                return None
            with open(path, "rb") as f:
                f.seek(size - _TRAILER.size)
                foff, magic = _TRAILER.unpack(f.read(_TRAILER.size))
                if magic != _TRAILER_MAGIC or foff + _HEAD > size:
                    return None
                f.seek(foff)
                head = f.read(_HEAD)
                if head[:_CID] != FOOTER_CID:
                    return None
                (plen,) = _LEN.unpack(head[_CID:])
                if foff + _HEAD + plen + _TRAILER.size != size:
                    return None
                body = f.read(plen)
            _, count = _FOOT_HEAD.unpack_from(body, 0)
            if _FOOT_HEAD.size + count * _FOOT_ENTRY.size != plen:
                return None
            return [_FOOT_ENTRY.unpack_from(body, _FOOT_HEAD.size
                                            + i * _FOOT_ENTRY.size)
                    for i in range(count)]
        except (OSError, struct.error):
            return None

    def _scan(self, path: str):
        """Record scan for a footer-less (active) segment: parse records
        sequentially, truncating any torn tail ON DISK so post-crash
        appends land at a parseable offset."""
        size = os.path.getsize(path)
        entries: list[tuple[int, int, bytes]] = []
        good = 0
        verify = self.verify
        with open(path, "rb") as f:
            while True:
                off = f.tell()
                head = f.read(_HEAD)
                if len(head) < _HEAD:
                    break
                cid = head[:_CID]
                (ln,) = _LEN.unpack(head[_CID:])
                if cid == FOOTER_CID:
                    # sealed segment whose trailer was damaged: trust the
                    # records scanned so far and stop at the footer
                    if off + _HEAD + ln > size:
                        break
                    good = size
                    break
                if ln == _TOMBSTONE:
                    entries.append((off, _TOMBSTONE, cid))
                    good = f.tell()
                    continue
                if off + _HEAD + ln > size:
                    break                    # torn tail write
                if verify:
                    check_chunks(self.stats, [f.read(ln)], [cid],
                                 "segment replay")
                else:
                    f.seek(ln, 1)
                entries.append((off, ln, cid))
                good = f.tell()
        if good < size:
            os.truncate(path, good)
            obs_emit("storage.torn_tail", backend="segment", path=path,
                     dropped_bytes=size - good, offset=good)
        return entries

    # ------------------------------------------------------------- append
    def _roll(self, gen: int) -> None:
        if self._wf is not None:
            self._wf.close()
        seg = _Segment(gen, self._path(gen))
        self._segments[gen] = seg
        self._active = seg
        self._wf = open(seg.path, "ab")

    def _seal_active(self) -> None:
        """Footer + trailer + fsync: the segment becomes immutable and
        rebuildable without a scan."""
        seg = self._active
        footer = _pack_footer(seg.gen, seg.records)
        self._wf.write(footer + _TRAILER.pack(seg.size, _TRAILER_MAGIC))
        self._fsync()
        seg.size += len(footer) + _TRAILER.size
        seg.sealed = True
        seg.records = None
        self._roll(seg.gen + 1)
        fsync_dir(self.root)                 # the new file's dir entry

    def _put_many_impl(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        provided = ([] if cids is None else
                    [i for i, c in enumerate(cids) if c is not None])
        out = resolve_cids(raws, cids)
        st = self.stats
        if self.verify and provided:
            check_chunks(st, [raws[i] for i in provided],
                         [out[i] for i in provided], "Put-Chunk")
        st.put_batches += 1
        for raw, cid in zip(raws, out):
            st.puts += 1
            st.logical_bytes += len(raw)
            if cid in self._index:
                st.dedup_hits += 1           # immediate ack (§4.4)
                continue
            seg = self._active
            off = seg.size
            self._wf.write(cid + _LEN.pack(len(raw)) + raw)
            seg.records.append((off, len(raw), cid))
            seg.live[cid] = (off + _HEAD, len(raw))
            seg.data_bytes += len(raw)
            seg.size += _HEAD + len(raw)
            self._index[cid] = seg.gen
            st.physical_bytes += len(raw)
            if seg.size >= self.segment_bytes:
                self._seal_active()
        self._notify_put(out)
        return out

    # ------------------------------------------------------------- read
    def _rfd(self, gen: int) -> int:
        fd = self._rfds.get(gen)
        if fd is None:
            fd = self._rfds[gen] = os.open(self._segments[gen].path,
                                           os.O_RDONLY)
        return fd

    def _map(self, gen: int) -> mmap.mmap:
        """A sealed segment's read-only map: a read copies its record out
        of the page cache instead of making one syscall a chunk (the
        syscalls cost a cold read more than its copies, and vary with the
        host's load).  A sealed file never changes in place; compaction
        swaps in a new file and drops the map with the fd
        (``_close_rfd``)."""
        mm = self._maps.get(gen)
        if mm is None:
            mm = self._maps[gen] = mmap.mmap(self._rfd(gen), 0,
                                             access=mmap.ACCESS_READ)
        return mm

    def _get_many_impl(self, cids) -> list[bytes]:
        st = self.stats
        ns0 = st.verify_ns
        # while obs is on, a read batch is one span: its chunks, their
        # bytes and the time of their checks (verify_ns's growth in it)
        with obs_trace("segment.get", chunks=len(cids)) as sp:
            st.get_batches += 1
            if self._wf is not None:
                self._wf.flush()             # active appends visible to pread
            out = []
            missing = None
            for cid in cids:
                st.gets += 1
                gen = self._index.get(cid)
                if gen is None:
                    missing = cid
                    break
                seg = self._segments[gen]
                off, ln = seg.live[cid]
                out.append(self._map(gen)[off:off + ln] if seg.sealed
                           else os.pread(self._rfd(gen), ln, off))
            # the chunks read are checked as one batch, and a bad one is
            # reported before a missing chunk that follows it
            if self.verify and out:
                check_chunks(st, out, cids[:len(out)], "Get-Chunk")
            if missing is not None:
                raise ChunkMissing(missing)
            if sp is not None:
                sp.set(bytes=sum(map(len, out)), check_ns=st.verify_ns - ns0)
        return out

    def has_many(self, cids) -> list[bool]:
        return [cid in self._index for cid in cids]

    # ------------------------------------------------------------ delete
    def _delete_many_impl(self, cids) -> int:
        st = self.stats
        n = 0
        for cid in cids:
            gen = self._index.pop(cid, None)
            if gen is None:
                continue                     # absent cids are a no-op
            seg = self._segments[gen]
            _, ln = seg.live.pop(cid)
            seg.dead[cid] = seg.dead.get(cid, 0) + ln
            seg.dead_bytes += ln
            act = self._active
            act.records.append((act.size, _TOMBSTONE, cid))
            act.tombs.add(cid)
            self._wf.write(cid + _LEN.pack(_TOMBSTONE))
            act.size += _HEAD
            n += 1
            st.deletes += 1
            st.physical_bytes -= ln
            st.reclaimed_bytes += ln
            if act.size >= self.segment_bytes:
                self._seal_active()
        return n

    def iter_cids(self):
        """Sweep inventory, streamed one segment at a time — a snapshot
        per segment generation, never one store-wide copy."""
        for gen in sorted(self._segments):
            seg = self._segments.get(gen)
            if seg is not None:
                yield from list(seg.live)

    def __len__(self) -> int:
        return len(self._index)

    def flush(self) -> None:
        """Durability point: fsync the active segment, then feed any
        GC-sweep output to the compactor (sealed segments past the dead
        threshold are rewritten)."""
        if self._wf is not None:
            self._fsync()
        if self.auto_compact:
            self.maybe_compact()

    def _fsync(self) -> None:
        """The active segment's buffered appends to disk, fsynced."""
        with obs_trace("segment.fsync"):
            self._wf.flush()
            os.fsync(self._wf.fileno())

    # -------------------------------------------------------- compaction
    def _tomb_needed(self, gen: int, cid: bytes) -> bool:
        """A tombstone must survive its segment's rewrite while any
        EARLIER segment still physically holds a record for its cid —
        dropping it would resurrect that record on the next replay."""
        return any(g < gen and cid in s.dead
                   for g, s in self._segments.items())

    def compactable(self):
        """Generations of sealed segments past the dead-ratio threshold
        (the compaction work queue the GC sweep feeds)."""
        return sorted(
            gen for gen, seg in self._segments.items()
            if seg.sealed and seg.dead_bytes > 0
            and (seg.dead_ratio >= self.compact_ratio
                 or not seg.live))

    def compact(self, gen: int) -> tuple[int, int]:
        """Rewrite one sealed segment live-chunks-only (plus still-needed
        tombstones) and atomically swap it in; returns (file bytes
        before, after).  A rewrite that leaves no records at all deletes
        the segment file instead."""
        seg = self._segments[gen]
        if not seg.sealed:
            raise ConfigError(f"segment {gen} is active")
        before = seg.size
        keep_tombs = sorted(c for c in seg.tombs
                            if self._tomb_needed(gen, c))
        lives = sorted(seg.live.items(), key=lambda kv: kv[1][0])
        fd = self._rfd(gen)
        if not keep_tombs and not lives:     # fully dead: drop the file
            self._drop_segment(gen)
            self.stats.compactions += 1
            self.stats.compacted_bytes += before
            obs_emit("segment.compaction", gen=gen, bytes_before=before,
                     bytes_after=0, dropped=True)
            return before, 0
        tmp = seg.path + ".compact"
        records: list[tuple[int, int, bytes]] = []
        new_live: dict[bytes, tuple[int, int]] = {}
        off = 0
        with open(tmp, "wb") as f:
            # tombstones FIRST: a kept tombstone targets an earlier
            # segment, and a live re-put of the same cid in this segment
            # must replay after it, not be killed by it
            for cid in keep_tombs:
                f.write(cid + _LEN.pack(_TOMBSTONE))
                records.append((off, _TOMBSTONE, cid))
                off += _HEAD
            for cid, (poff, ln) in lives:
                f.write(cid + _LEN.pack(ln) + os.pread(fd, ln, poff))
                records.append((off, ln, cid))
                new_live[cid] = (off + _HEAD, ln)
                off += _HEAD + ln
            footer = _pack_footer(gen, records)
            f.write(footer + _TRAILER.pack(off, _TRAILER_MAGIC))
            f.flush()
            os.fsync(f.fileno())
        replace_durably(tmp, seg.path)
        self._close_rfd(gen)
        seg.live = new_live
        seg.dead = {}
        seg.tombs = set(keep_tombs)
        seg.data_bytes = sum(ln for _, ln in new_live.values())
        seg.dead_bytes = 0
        seg.size = off + len(footer) + _TRAILER.size
        self.stats.compactions += 1
        self.stats.compacted_bytes += before - seg.size
        obs_emit("segment.compaction", gen=gen, bytes_before=before,
                 bytes_after=seg.size, dropped=False)
        return before, seg.size

    def compact_step(self):
        """Compact the single most-dead eligible segment (one bounded
        unit of background maintenance work); returns (gen, bytes
        before, bytes after) or None when nothing is eligible."""
        todo = self.compactable()
        if not todo:
            return None
        gen = max(todo, key=lambda g: self._segments[g].dead_bytes)
        before, after = self.compact(gen)
        return gen, before, after

    def maybe_compact(self) -> int:
        """Drain the compaction queue; returns file bytes reclaimed."""
        freed = 0
        while True:
            step = self.compact_step()
            if step is None:
                return freed
            _, before, after = step
            freed += before - after

    def _drop_segment(self, gen: int) -> None:
        seg = self._segments.pop(gen)
        self._close_rfd(gen)
        os.remove(seg.path)
        fsync_dir(self.root)

    def _close_rfd(self, gen: int) -> None:
        mm = self._maps.pop(gen, None)
        if mm is not None:
            mm.close()
        fd = self._rfds.pop(gen, None)
        if fd is not None:
            os.close(fd)

    # ------------------------------------------------------ introspection
    def disk_bytes(self) -> int:
        """Total on-disk segment bytes (the durable footprint)."""
        if self._wf is not None:
            self._wf.flush()
        return sum(os.path.getsize(s.path)
                   for s in self._segments.values()
                   if os.path.exists(s.path))

    def segment_count(self) -> int:
        return len(self._segments)

    def dead_bytes(self) -> int:
        return sum(s.dead_bytes for s in self._segments.values())

    def close(self) -> None:
        """Release file handles (reopen by constructing a new backend)."""
        if self._wf is not None:
            self._wf.flush()
            os.fsync(self._wf.fileno())
            self._wf.close()
            self._wf = None
        for gen in list(self._rfds):
            self._close_rfd(gen)
