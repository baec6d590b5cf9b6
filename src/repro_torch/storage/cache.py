"""LRU read-cache layer: composes over any StorageBackend, serving hot
chunk reads from memory (the paper's servlets keep hot tree nodes
resident; this is that layer made explicit and stackable)."""
from __future__ import annotations

from collections import OrderedDict

from .backend import (BackendBase, check_chunk, delete_via,
                      overlay_get_many, overlay_has_many, put_via)


class LRUCacheBackend(BackendBase):
    """Write-through LRU over ``inner``, bounded by ``capacity_bytes``.

    With ``verify=True`` cache HITS are re-hashed before being served:
    without it a flipped bit in the resident copy would be returned with
    no integrity check at all, because verified leaf stores only see the
    misses (the tamper-evidence conformance suite covers this)."""

    OBS_NAME = "lru"

    def __init__(self, inner, capacity_bytes: int = 64 << 20,
                 verify: bool = False):
        super().__init__()
        self.inner = inner
        self.capacity_bytes = capacity_bytes
        self.verify = verify
        self._cache: OrderedDict[bytes, bytes] = OrderedDict()
        self._cache_bytes = 0

    def _admit(self, cid: bytes, raw: bytes) -> None:
        if cid in self._cache:
            self._cache.move_to_end(cid)
            return
        self._cache[cid] = raw
        self._cache_bytes += len(raw)
        while self._cache_bytes > self.capacity_bytes and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= len(old)

    # ------------------------------------------------------------ batched
    def _put_many_impl(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        st = self.stats
        st.put_batches += 1
        out, _, _ = put_via(st, self.inner, raws, cids)
        for raw, cid in zip(raws, out):
            st.puts += 1
            st.logical_bytes += len(raw)
            self._admit(cid, raw)
        self._notify_put(out)
        return out

    def _get_many_impl(self, cids) -> list[bytes]:
        st = self.stats
        st.get_batches += 1
        st.gets += len(cids)

        def on_hit(cid):
            self._cache.move_to_end(cid)
            st.cache_hits += 1
            if self.verify:
                from ..core.chunk import cid_of
                if not check_chunk(st, cid_of, self._cache[cid], cid):
                    from .backend import TamperedChunk
                    raise TamperedChunk(cid, "cache hit")

        return overlay_get_many(self._cache, cids, self.inner.get_many,
                                on_hit=on_hit, on_fetch=self._admit)

    def has_many(self, cids) -> list[bool]:
        return overlay_has_many(self._cache, cids, self.inner.has_many)

    def _delete_many_impl(self, cids) -> int:
        # invalidate cache entries first so a concurrent read can't serve
        # a deleted chunk from the overlay
        for cid in cids:
            raw = self._cache.pop(cid, None)
            if raw is not None:
                self._cache_bytes -= len(raw)
        return delete_via(self.stats, self.inner, cids)

    def iter_cids(self):
        return self.inner.iter_cids()

    @property
    def hit_rate(self) -> float:
        return self.stats.cache_hits / max(1, self.stats.gets)

    def __len__(self) -> int:
        return len(self.inner)

    def flush(self) -> None:
        self.inner.flush()
