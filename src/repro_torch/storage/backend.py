"""StorageBackend — the single pluggable chunk-storage abstraction.

Every store in the engine (memory, log-structured file, LRU cache,
replication, sharding, cluster routing) implements one protocol whose
core surface is *batched*: ``put_many``/``get_many``/``has_many``.
Batching is what keeps POS-Tree construction off the critical path
(paper §4.6.1): a value with N chunks commits with one ``put_many``
call, whose cid computation routes through the vectorized hash entry
point (``core.hashing.content_hash_many``) and can dispatch to the
``fphash`` CUDA kernel — one kernel launch per batch, many chunks per
launch — instead of N serial host hashes.

Singular ``put``/``get``/``has`` are thin wrappers over the batched
calls (``BackendBase``), so legacy call sites keep working and count as
batches of one.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from time import perf_counter as _perf
from typing import Iterator, Protocol, Sequence, runtime_checkable

from ..errors import ChunkMissing, TamperedChunk
from ..obs import REGISTRY as _OBS
from ..obs import trace as _trace

__all__ = [
    "BackendBase", "ChunkMissing", "StorageBackend", "StoreStats",
    "TamperedChunk", "delete_via", "group_by", "overlay_get_many",
    "overlay_has_many", "put_via", "resolve_cids",
]


@dataclass
class StoreStats:
    puts: int = 0                 # Put-Chunk requests (per chunk)
    put_batches: int = 0          # put_many calls (the batching win metric)
    dedup_hits: int = 0           # Puts acknowledged via existing cid
    gets: int = 0                 # Get-Chunk requests (per chunk)
    get_batches: int = 0          # get_many calls
    cache_hits: int = 0           # reads served by a cache layer
    deletes: int = 0              # chunks actually removed (per chunk)
    verifies: int = 0             # chunk-hash integrity checks performed
    verify_failures: int = 0      # checks that caught tampering/corruption
    logical_bytes: int = 0        # sum of bytes across all Puts
    physical_bytes: int = 0       # bytes actually stored (post-dedup)
    reclaimed_bytes: int = 0      # physical bytes freed by deletes
    tier_hits: int = 0            # reads served by the hot (memory) tier
    tier_misses: int = 0          # reads that fell through to the cold tier
    tier_demotions: int = 0       # chunks written back to the cold tier
    tier_promotions: int = 0      # cold chunks re-admitted hot on read
    compactions: int = 0          # segment rewrites (log-structured stores)
    compacted_bytes: int = 0      # file bytes reclaimed by those rewrites

    @property
    def dedup_ratio(self) -> float:
        return self.logical_bytes / max(1, self.physical_bytes)

    @property
    def tier_hit_rate(self) -> float:
        return self.tier_hits / max(1, self.tier_hits + self.tier_misses)

    def as_dict(self) -> dict:
        """Every counter plus the derived ratios — the one exhaustive
        export surface, so a newly added field reaches every consumer
        (benches, snapshots) without another hand-picked list."""
        out = {f.name: getattr(self, f.name) for f in fields(self)}
        out["dedup_ratio"] = self.dedup_ratio
        out["tier_hit_rate"] = self.tier_hit_rate
        return out

    def merge(self, other: "StoreStats") -> "StoreStats":
        """Accumulate another stats block into this one (cluster-wide
        rollups).  Returns self for chaining."""
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other,
                                                                  f.name))
        return self


@runtime_checkable
class StorageBackend(Protocol):
    """What every chunk store implements.  Content-addressed, immutable
    chunks; dedup on Put (existing cids are acknowledged, not rewritten);
    missing reads raise ChunkMissing.  ``delete_many`` is the GC sweep
    verb: it removes chunks everywhere they are materialized (every
    replica, the owning shard, cache entries) and is a no-op for absent
    cids; ``iter_cids`` enumerates the distinct stored cids (the sweep
    inventory)."""

    stats: StoreStats

    def put_many(self, raws: Sequence[bytes],
                 cids: Sequence[bytes | None] | None = None) -> list[bytes]:
        ...

    def get_many(self, cids: Sequence[bytes]) -> list[bytes]:
        ...

    def has_many(self, cids: Sequence[bytes]) -> list[bool]:
        ...

    def delete_many(self, cids: Sequence[bytes]) -> int:
        ...

    def iter_cids(self) -> "Iterator[bytes]":
        ...

    def put(self, raw: bytes, cid: bytes | None = None) -> bytes:
        ...

    def get(self, cid: bytes) -> bytes:
        ...

    def has(self, cid: bytes) -> bool:
        ...

    def delete(self, cid: bytes) -> int:
        ...

    def __len__(self) -> int:
        ...

    def flush(self) -> None:
        ...


def resolve_cids(raws: Sequence[bytes],
                 cids: Sequence[bytes | None] | None) -> list[bytes]:
    """Fill in missing cids with one vectorized hash batch."""
    # Imported lazily: core imports storage (chunkstore shim), so a
    # module-scope import here would cycle through the core package.
    from ..core.hashing import content_hash_many

    if cids is None:
        return content_hash_many(raws)
    out = list(cids)
    missing = [i for i, c in enumerate(out) if c is None]
    if missing:
        hashed = content_hash_many([raws[i] for i in missing])
        for i, h in zip(missing, hashed):
            out[i] = h
    return out


def group_by(owner_of, cids: Sequence[bytes],
             payloads: Sequence[bytes] | None = None
             ) -> "dict[int, tuple[list[int], list[bytes], list[bytes]]]":
    """Partition a batch by owner for scatter/gather routing: returns
    {owner: (original indices, cids, payloads)}.  ``owner_of(i, cid)``
    lets the caller pin by payload too (e.g. meta chunks -> home node)."""
    groups: dict[int, tuple[list[int], list[bytes], list[bytes]]] = {}
    for i, cid in enumerate(cids):
        g = groups.setdefault(owner_of(i, cid), ([], [], []))
        g[0].append(i)
        g[1].append(cid)
        if payloads is not None:
            g[2].append(payloads[i])
    return groups


def overlay_get_many(local: dict, cids: Sequence[bytes], fetch,
                     on_hit=None, on_fetch=None) -> list[bytes]:
    """Serve a read batch from a local dict overlay, forwarding only the
    misses to ``fetch`` in one call (shared by WriteBuffer pending reads
    and the LRU cache)."""
    out: list[bytes | None] = []
    miss_idx: list[int] = []
    miss_cids: list[bytes] = []
    for i, cid in enumerate(cids):
        raw = local.get(cid)
        out.append(raw)
        if raw is None:
            miss_idx.append(i)
            miss_cids.append(cid)
        elif on_hit is not None:
            on_hit(cid)
    if miss_cids:
        for i, cid, raw in zip(miss_idx, miss_cids, fetch(miss_cids)):
            out[i] = raw
            if on_fetch is not None:
                on_fetch(cid, raw)
    return out  # type: ignore[return-value]


def overlay_has_many(local: dict, cids: Sequence[bytes],
                     inner_has_many) -> list[bool]:
    """has_many against a local overlay + inner backend, batching the
    inner probe."""
    in_local = [cid in local for cid in cids]
    if all(in_local):
        return in_local
    rest = iter(inner_has_many([c for c, hit in zip(cids, in_local)
                                if not hit]))
    return [hit or next(rest) for hit in in_local]


def delete_via(stats: StoreStats, child, cids: Sequence[bytes], *,
               count_deletes: bool = True) -> int:
    """Forward one group of deletes to a child backend and absorb its
    reclaimed-bytes delta into ``stats`` (the sweep-side twin of
    ``put_via``).  Returns the child's removed-chunk count."""
    d0 = child.stats.deletes
    r0 = child.stats.reclaimed_bytes
    n = child.delete_many(cids)
    freed = child.stats.reclaimed_bytes - r0
    if count_deletes:
        stats.deletes += child.stats.deletes - d0
    stats.physical_bytes -= freed
    stats.reclaimed_bytes += freed
    return n


def put_via(stats: StoreStats, child, raws: Sequence[bytes],
            cids: Sequence[bytes | None] | None, *,
            count_dedup: bool = True) -> tuple[list[bytes], int, int]:
    """Forward one group of chunks to a child backend and absorb its
    dedup/physical deltas into ``stats`` (the shared bookkeeping of every
    composite backend: cache, sharded, replicated, routing).  Returns
    (cids, newly stored chunk count, newly stored bytes)."""
    c0 = len(child)
    d0 = child.stats.dedup_hits
    p0 = child.stats.physical_bytes
    out = child.put_many(raws, cids)
    new_bytes = child.stats.physical_bytes - p0
    if count_dedup:
        stats.dedup_hits += child.stats.dedup_hits - d0
    stats.physical_bytes += new_bytes
    return out, len(child) - c0, new_bytes


class BackendBase:
    """Common plumbing: stats + singular ops as batches of one, plus the
    put-notification hook every backend fires for the GC write barrier.

    The batched verbs are *instrumented dispatchers*: ``put_many`` /
    ``get_many`` / ``delete_many`` check the global observability flag
    and delegate to the subclass ``_put_many_impl`` / ``_get_many_impl``
    / ``_delete_many_impl``.  When enabled, writes and deletes open a
    ``store.put`` / ``store.delete`` span (nesting under whatever layer
    called them — engine, routing, tiered — via the trace contextvar)
    and reads record into a per-backend latency histogram; when
    disabled the whole cost is one flag check.  ``WriteBuffer``
    deliberately overrides the batched verbs directly: its per-chunk
    accumulation during tree build is too hot to instrument, and its
    flush lands on an instrumented inner ``put_many`` anyway."""

    #: Label used for span attrs and histogram labels; subclasses set it
    #: (falls back to the class name).
    OBS_NAME = ""

    def __init__(self) -> None:
        self.stats = StoreStats()
        self._put_listeners: list = []
        self._obs_hists: dict = {}
        self._obs_tick = 7           # 1-in-8 read sampling; first sampled

    # ---- GC write barrier (incremental collection) ----
    def add_put_listener(self, fn) -> None:
        """Register ``fn(cids)`` to fire after every put batch lands.
        Dedup acks are included: a put that merely re-references an
        existing chunk must still shade it, or an in-flight collection
        could sweep a chunk a brand-new version just adopted."""
        self._put_listeners.append(fn)

    def remove_put_listener(self, fn) -> None:
        try:
            self._put_listeners.remove(fn)
        except ValueError:
            pass

    def _notify_put(self, cids) -> None:
        for fn in list(self._put_listeners):
            fn(cids)

    # ---- observability plumbing ----
    def _obs_label(self) -> str:
        return self.OBS_NAME or type(self).__name__

    def _obs_hist(self, verb: str):
        h = self._obs_hists.get(verb)
        if h is None:
            # repro: allow(OBS001): only reached from dispatchers that
            # already checked _OBS.enabled; the handle is memoized so
            # this runs once per (backend, verb), not per operation
            h = _OBS.histogram(f"store_{verb}_us",
                               {"backend": self._obs_label()})
            self._obs_hists[verb] = h
        return h

    # ---- instrumented batched dispatchers ----
    def put_many(self, raws: Sequence[bytes],
                 cids: Sequence[bytes | None] | None = None) -> list[bytes]:
        if not _OBS.enabled:
            return self._put_many_impl(raws, cids)
        with _trace("store.put", _hist=self._obs_hist("put"),
                    backend=self._obs_label(), chunks=len(raws)) as sp:
            out = self._put_many_impl(raws, cids)
            sp.set(bytes=sum(map(len, raws)))
        return out

    def get_many(self, cids: Sequence[bytes]) -> list[bytes]:
        # reads are histogram-only (no span), single-cid batches skip the
        # timer entirely (index walks do one tiny get per tree level),
        # and multi-cid batches are timed at a 1-in-8 sample: a uniform
        # sample keeps the latency distribution honest while the per-call
        # tax the obs-overhead gate guards stays at one counter bump.
        # StoreStats still counts every get inside the impl.
        if not _OBS.enabled or len(cids) < 2:
            return self._get_many_impl(cids)
        self._obs_tick = tick = (self._obs_tick + 1) & 7
        if tick:
            return self._get_many_impl(cids)
        t0 = _perf()
        out = self._get_many_impl(cids)
        self._obs_hist("get").observe(_perf() - t0)
        return out

    def delete_many(self, cids: Sequence[bytes]) -> int:
        if not _OBS.enabled:
            return self._delete_many_impl(cids)
        with _trace("store.delete", _hist=self._obs_hist("delete"),
                    backend=self._obs_label(), chunks=len(cids)):
            return self._delete_many_impl(cids)

    def put(self, raw: bytes, cid: bytes | None = None) -> bytes:
        return self.put_many([raw], [cid])[0]

    def get(self, cid: bytes) -> bytes:
        return self.get_many([cid])[0]

    def has(self, cid: bytes) -> bool:
        return self.has_many([cid])[0]

    def delete(self, cid: bytes) -> int:
        return self.delete_many([cid])

    def flush(self) -> None:
        pass

    # subclasses implement _put_many_impl / _get_many_impl / has_many /
    # _delete_many_impl / iter_cids / __len__ (WriteBuffer overrides the
    # batched verbs themselves — see class docstring)
