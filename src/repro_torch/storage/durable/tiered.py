"""Hot/cold tiered store: an in-memory LRU hot tier over a durable cold
backend (LiveDB/ArchiveDB split from "Efficient Forkless Blockchain
Databases"; the durable counterpart of the reference's in-memory
LiveTable).

New chunks land *hot and dirty* — memory-only, not yet in the cold
tier.  When the hot tier overflows ``hot_bytes`` the least-recently-used
chunks are evicted: dirty ones are first demoted (written back to the
cold tier in one batch) so a live chunk is never dropped from its last
copy; clean ones — already durable below — are simply forgotten.  Reads
hit hot first; misses fetch from cold and promote (admitted clean).
``flush()`` demotes every remaining dirty chunk and then flushes the
cold tier, so after a flush the full store contents are durable and a
reopen over the same cold backend sees everything.

Deletes are the GC sweep verb: a dirty chunk dies entirely in memory
(it never reached disk), anything else is forwarded to the cold tier;
either way the chunk leaves both tiers.  The GC write barrier fires via
``_notify_put`` on this composite, exactly like every other stack.

Tier traffic is observable through the ``tier_hits`` / ``tier_misses``
/ ``tier_demotions`` / ``tier_promotions`` StoreStats counters, and the
cold tier's compaction activity (GC-fed) is absorbed into this store's
``compactions``/``compacted_bytes`` on flush so one stats object tells
the whole story.
"""
from __future__ import annotations

from collections import OrderedDict

from ...obs import emit as obs_emit
from ...obs import trace as obs_trace
from ..backend import (BackendBase, StorageBackend, check_chunks,
                       delete_via, overlay_has_many, resolve_cids)

# StoreStats fields the cold tier recovers by log/footer replay on open;
# a freshly constructed TieredBackend adopts them as its own baseline so
# stats survive a restart the same way MemoryBackend's replay does.
_REPLAYED_FIELDS = ("puts", "dedup_hits", "deletes", "logical_bytes",
                    "physical_bytes", "reclaimed_bytes")


class TieredBackend(BackendBase):
    """LRU memory hot tier + durable cold tier, GC-liveness aware."""

    OBS_NAME = "tiered"

    def __init__(self, cold: StorageBackend, *, hot_bytes: int = 64 << 20,
                 verify: bool = False):
        super().__init__()
        self.cold = cold
        self.hot_bytes = hot_bytes
        self.verify = verify
        self._hot: OrderedDict[bytes, bytes] = OrderedDict()
        self._hot_size = 0
        self._dirty: set[bytes] = set()      # hot-only, not yet durable
        for field in _REPLAYED_FIELDS:
            setattr(self.stats, field, getattr(cold.stats, field))

    # ------------------------------------------------------------- write
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
        # one batched existence probe against the cold tier for dedup
        unknown = [c for c in dict.fromkeys(out) if c not in self._hot]
        in_cold = (dict(zip(unknown, self.cold.has_many(unknown)))
                   if unknown else {})
        for raw, cid in zip(raws, out):
            st.puts += 1
            st.logical_bytes += len(raw)
            if cid in self._hot:
                st.dedup_hits += 1
                self._hot.move_to_end(cid)
                continue
            if in_cold.get(cid):
                st.dedup_hits += 1
                continue
            self._admit(cid, raw, dirty=True)
            in_cold[cid] = False             # later dups hit the hot branch
            st.physical_bytes += len(raw)
        self._evict()
        self._notify_put(out)
        return out

    def _admit(self, cid: bytes, raw: bytes, *, dirty: bool) -> None:
        self._hot[cid] = raw
        self._hot_size += len(raw)
        if dirty:
            self._dirty.add(cid)

    def _evict(self) -> None:
        """Shed LRU chunks past ``hot_bytes``; dirty evictees are demoted
        (written back) in ONE cold put batch before they leave memory."""
        demote_cids: list[bytes] = []
        demote_raws: list[bytes] = []
        while self._hot_size > self.hot_bytes and len(self._hot) > 1:
            cid, raw = self._hot.popitem(last=False)
            self._hot_size -= len(raw)
            if cid in self._dirty:
                self._dirty.discard(cid)
                demote_cids.append(cid)
                demote_raws.append(raw)
        if demote_cids:
            self.stats.tier_demotions += len(demote_cids)
            # direct child call, not put_via: these bytes are already in
            # this store's physical_bytes — demotion moves, not adds
            self.cold.put_many(demote_raws, demote_cids)
            obs_emit("tier.demote", chunks=len(demote_cids),
                     bytes=sum(map(len, demote_raws)), cause="overflow")

    def demote(self, target_bytes: int = 0) -> int:
        """Age-out policy hook: write back + evict LRU chunks until the
        hot tier holds at most ``target_bytes``.  Returns chunks shed."""
        before = len(self._hot)
        keep, self.hot_bytes = self.hot_bytes, target_bytes
        try:
            self._evict()
            if self._hot_size > target_bytes and self._hot:
                cid, raw = self._hot.popitem(last=False)  # the >1 guard's last
                self._hot_size -= len(raw)
                if cid in self._dirty:
                    self._dirty.discard(cid)
                    self.stats.tier_demotions += 1
                    self.cold.put_many([raw], [cid])
        finally:
            self.hot_bytes = keep
        return before - len(self._hot)

    # -------------------------------------------------------------- read
    def _get_many_impl(self, cids) -> list[bytes]:
        st = self.stats
        st.get_batches += 1
        st.gets += len(cids)
        hot = self._hot
        out = [hot.get(cid) for cid in cids]
        hits = [i for i, raw in enumerate(out) if raw is not None]
        for i in hits:
            hot.move_to_end(cids[i])
        st.cache_hits += len(hits)
        st.tier_hits += len(hits)
        # the hits are checked as one batch before any miss is fetched
        if self.verify and hits:
            check_chunks(st, [out[i] for i in hits], [cids[i] for i in hits],
                         "hot-tier hit")
        miss = [i for i, raw in enumerate(out) if raw is None]
        if miss:
            st.tier_misses += len(miss)
            fetched = self.cold.get_many([cids[i] for i in miss])
            for i, raw in zip(miss, fetched):
                out[i] = raw
                self._admit(cids[i], raw, dirty=False)
            st.tier_promotions += len(miss)
        self._evict()
        if miss:
            obs_emit("tier.promote", chunks=len(miss))
        return out

    def has_many(self, cids) -> list[bool]:
        return overlay_has_many(self._hot, cids, self.cold.has_many)

    # ------------------------------------------------------------ delete
    def _delete_many_impl(self, cids) -> int:
        st = self.stats
        n = 0
        cold_cids: list[bytes] = []
        for cid in cids:
            raw = self._hot.pop(cid, None)
            if raw is not None:
                self._hot_size -= len(raw)
                if cid in self._dirty:       # never reached disk: done
                    self._dirty.discard(cid)
                    n += 1
                    st.deletes += 1
                    st.physical_bytes -= len(raw)
                    st.reclaimed_bytes += len(raw)
                    continue
            cold_cids.append(cid)
        if cold_cids:
            n += delete_via(st, self.cold, cold_cids)
        return n

    def iter_cids(self):
        """Dirty (hot-only) cids, then the cold tier's stream — the two
        sets are disjoint by construction (a chunk becomes clean the
        moment it is demoted)."""
        yield from list(self._dirty)
        yield from self.cold.iter_cids()

    def __len__(self) -> int:
        return len(self._dirty) + len(self.cold)

    # --------------------------------------------------------- lifecycle
    def flush(self) -> None:
        """Durability point: demote every dirty chunk in one batch, then
        flush the cold tier (fsync + GC-fed compaction below)."""
        with obs_trace("tier.flush"):
            if self._dirty:
                cids = list(self._dirty)
                raws = [self._hot[c] for c in cids]
                self.stats.tier_demotions += len(cids)
                self.cold.put_many(raws, cids)
                self._dirty.clear()
                obs_emit("tier.demote", chunks=len(cids),
                         bytes=sum(map(len, raws)), cause="flush")
            n0 = self.cold.stats.compactions
            b0 = self.cold.stats.compacted_bytes
            self.cold.flush()
            self.stats.compactions += self.cold.stats.compactions - n0
            self.stats.compacted_bytes += (self.cold.stats.compacted_bytes
                                           - b0)

    def close(self) -> None:
        self.flush()
        if hasattr(self.cold, "close"):
            self.cold.close()

    @property
    def hot_count(self) -> int:
        return len(self._hot)

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)
