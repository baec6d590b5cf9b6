"""WriteBuffer — the batched chunk pipeline (paper §4.6.1).

A write-behind layer that accumulates every chunk of one logical value
(POS-Tree leaves, index nodes, the meta chunk) and commits them to the
inner backend with a *single* ``put_many`` call on ``flush()``.  cids
are computed eagerly in vectorized batches (``content_hash_many``), so
tree construction can keep linking nodes by cid while no per-chunk
store round-trip happens; reads see pending chunks.

The duplicate-preserving raw list means the inner backend observes the
same logical Put stream it would have seen unbatched — dedup counters
and logical/physical byte stats are unchanged.

After ``flush()`` the buffer *closes* and becomes a transparent
pass-through, so a long-lived handle that kept a reference to it (e.g.
a POSTree whose ``store`` was a buffer during construction) continues
to read and write correctly against the inner backend.

Buffers nest: flushing an inner buffer into an outer one just moves the
batch up a level; only the outermost flush touches the real store.
"""
from __future__ import annotations

from ..obs import trace as _trace
from .backend import (BackendBase, overlay_get_many, overlay_has_many,
                      resolve_cids)


class WriteBuffer(BackendBase):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self._raws: list[bytes] = []
        self._cids: list[bytes] = []
        self._pending: dict[bytes, bytes] = {}
        self._closed = False

    # ------------------------------------------------------------ batched
    def put_many(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        if self._closed:
            out = self.inner.put_many(raws, cids)
            self._notify_put(out)
            return out
        out = resolve_cids(raws, cids)
        st = self.stats
        st.put_batches += 1
        for raw, cid in zip(raws, out):
            st.puts += 1
            st.logical_bytes += len(raw)
            # keep one canonical bytes object per cid: duplicate puts
            # append a reference, so peak memory is O(physical), while
            # flush still replays the full logical stream for stats
            self._raws.append(self._pending.setdefault(cid, raw))
            self._cids.append(cid)
        # a buffered put is not yet durable, but it IS visible to reads,
        # so a listener attached to the buffer hears about it now; the
        # inner store's listeners fire on flush (the real commit)
        self._notify_put(out)
        return out

    def get_many(self, cids) -> list[bytes]:
        if self._closed:
            return self.inner.get_many(cids)
        st = self.stats
        st.get_batches += 1
        st.gets += len(cids)
        return overlay_get_many(self._pending, cids, self.inner.get_many)

    def has_many(self, cids) -> list[bool]:
        if self._closed:
            return self.inner.has_many(cids)
        return overlay_has_many(self._pending, cids, self.inner.has_many)

    def delete_many(self, cids) -> int:
        """Open buffer: retract matching pending chunks (they will never
        reach the inner store) and pass the delete through; closed buffer:
        transparent pass-through.  A cid pending here AND already stored
        inner (dedup re-put) is one logical chunk — counted once."""
        if self._closed:
            return self.inner.delete_many(cids)
        cids = list(dict.fromkeys(cids))
        in_inner = self.inner.has_many(cids)
        drop = {cid for cid in cids if cid in self._pending}
        if drop:
            for cid in drop:
                del self._pending[cid]
            kept = [(r, c) for r, c in zip(self._raws, self._cids)
                    if c not in drop]
            self._raws = [r for r, _ in kept]
            self._cids = [c for _, c in kept]
        # the open buffer's stats never credited physical bytes (flush
        # hands the batch to inner), so only the delete count is ours to
        # track — inner's stats carry the physical reclaim
        self.inner.delete_many(cids)
        removed = sum(1 for cid, p in zip(cids, in_inner)
                      if p or cid in drop)
        self.stats.deletes += removed
        return removed

    def iter_cids(self):
        if self._closed:
            return self.inner.iter_cids()

        def chain():
            # snapshot only the (small) pending overlay; the inner
            # stream is consumed lazily so a segment/sharded inner can
            # keep yielding per-partition without one store-wide copy
            pending = list(self._pending)
            seen = set(pending)
            yield from pending
            for cid in self.inner.iter_cids():
                if cid not in seen:
                    yield cid

        return chain()

    # ------------------------------------------------------------- flush
    def flush(self) -> None:
        """Commit all pending chunks in one inner ``put_many`` and close."""
        if self._closed:
            self.inner.flush()
            return
        if self._raws:
            with _trace("buffer.flush"):
                self.inner.put_many(self._raws, self._cids)
        self._raws = []
        self._cids = []
        self._pending = {}
        self._closed = True

    @property
    def pending_chunks(self) -> int:
        return len(self._pending)

    def __len__(self) -> int:
        if self._closed:
            return len(self.inner)
        extra = sum(not p for p in self.inner.has_many(list(self._pending)))
        return len(self.inner) + extra

    @property
    def stats(self):
        # closed buffers are transparent: report the inner backend's stats
        return self.inner.stats if self._closed else self._stats

    @stats.setter
    def stats(self, value):
        self._stats = value
