"""Mark-and-sweep garbage collection over the version DAG.

ForkBase dedups on write (§4.4) but, like any content-addressed engine,
needs reachability-based collection to ever *shrink* (UStore makes the
same observation): dropping a branch head only detaches a subgraph —
the chunks it pinned stay in the store until something walks the DAG
and sweeps what no surviving head reaches.

Phases, all batched through the StorageBackend protocol:

  roots  TB + UB heads of every key (BranchTable.all_heads) plus the
         PinSet (in-flight readers, checkpoint retention holds).
  mark   BFS over chunk references, frontier-by-frontier: ONE
         ``get_many`` per DAG level (the read-side twin of the batched
         write pipeline, §4.6.1).  A meta chunk contributes its
         ``bases`` uids (history stays tamper-evident: everything a
         live head derives from is live) and, for chunkable types, its
         POS-Tree root cid; index chunks contribute their child cids;
         leaf chunks are terminal.
  sweep  inventory (``iter_cids``) minus live set, removed with one
         ``delete_many`` — each backend reclaims coherently (log
         tombstones, cache invalidation, all-replica delete, shard /
         cluster fan-out).
"""
from __future__ import annotations

from dataclasses import dataclass

from .pins import PinSet


@dataclass
class GCReport:
    roots: int = 0                # root uids the mark started from
    live_chunks: int = 0          # chunks reachable from the roots
    swept_chunks: int = 0         # chunks removed
    reclaimed_bytes: int = 0      # physical bytes freed by the sweep
    mark_rounds: int = 0          # store round-trips (= DAG depth levels)
    missing_roots: int = 0        # dangling tags/pins skipped by the mark
    epoch: int = 0                # incremental collection epoch (0 = STW)
    slices: int = 0               # step() calls an incremental run took
    barriered: int = 0            # chunks shaded/rescued by write barriers
    floating_garbage: int = 0     # swept chunks the PREVIOUS epoch kept
    #   alive only because they were orphaned mid-collection (snapshot-
    #   at-the-beginning trade); incremental epochs only — an STW
    #   collection has no preceding live-set handoff to count against
    compacted_bytes: int = 0      # segment-file bytes reclaimed by the
    #   compaction this sweep's flush fed (durable backends only)

    def __str__(self) -> str:
        dangling = (f", {self.missing_roots} dangling roots"
                    if self.missing_roots else "")
        floating = (f", {self.floating_garbage} floating"
                    if self.floating_garbage else "")
        compacted = (f", {self.compacted_bytes / 1e6:.2f} MB compacted"
                     if self.compacted_bytes else "")
        inc = (f" [epoch {self.epoch}: {self.slices} slices, "
               f"{self.barriered} barriered{floating}]"
               if self.epoch else "")
        return (f"GC: {self.roots} roots, {self.live_chunks} live, "
                f"{self.swept_chunks} swept "
                f"({self.reclaimed_bytes / 1e6:.2f} MB{compacted}) "
                f"in {self.mark_rounds} mark rounds{dangling}{inc}")


def chunk_refs(raw: bytes) -> list[bytes]:
    """Outgoing cid references of one serialized chunk (the edge
    function of the mark BFS)."""
    from ..core import chunk as ck
    from ..core.fobject import CHUNKABLE_TYPES, FObject

    t = ck.chunk_type(raw)
    if t == ck.META:
        obj = FObject.deserialize(raw, b"")
        refs = list(obj.bases)
        if obj.type in CHUNKABLE_TYPES:
            refs.append(obj.data)        # POS-Tree root cid
        return refs
    if t == ck.UINDEX:
        return [e.cid for e in ck.decode_uindex(ck.chunk_payload(raw))]
    if t == ck.SINDEX:
        return [e.cid for e in ck.decode_sindex(ck.chunk_payload(raw))]
    return []                            # leaf chunk: terminal


def expand_refs(store, cids, ref_hooks, live) -> list[bytes]:
    """One mark slice: read ``cids`` (one batched ``get_many``) and
    return their not-yet-seen references, adding them to ``live``.

    This is the shared inner loop of both collectors: ``mark`` feeds it
    whole BFS frontiers, the incremental collector feeds it
    budget-bounded slices of the gray queue.  Structural refs
    (``chunk_refs``) are strict — a missing one is corruption and raises
    ChunkMissing on the next slice; ``ref_hooks`` refs are soft and
    validated with one batched ``has_many``, so a value that merely
    looks like a cid cannot abort the mark."""
    nxt: list[bytes] = []
    soft: list[bytes] = []
    for raw in store.get_many(cids):
        for ref in chunk_refs(raw):
            if ref not in live:
                live.add(ref)
                nxt.append(ref)
        for hook in ref_hooks:
            for ref in hook(raw):
                if ref not in live:
                    soft.append(ref)
    if soft:
        soft = sorted(set(soft) - live)
        for ref, present in zip(soft, store.has_many(soft)):
            if present:
                live.add(ref)
                nxt.append(ref)
    return nxt


def filter_roots(store, roots) -> tuple[list[bytes], int]:
    """Drop dangling roots with one batched ``has_many``: roots come
    from user-controllable surfaces (tags, pins), so a stale one must
    not brick collection forever — it is reported, not raised.  Returns
    (present roots, missing count)."""
    want = sorted({bytes(u) for u in roots})
    frontier = [u for u, p in zip(want, store.has_many(want)) if p]
    return frontier, len(want) - len(frontier)


def mark(store, roots, ref_hooks=()) -> tuple[set[bytes], int, int]:
    """Batched reachability: returns (live cid set, store round-trips,
    count of missing roots)."""
    frontier, missing = filter_roots(store, roots)
    live: set[bytes] = set(frontier)
    rounds = 0
    while frontier:
        rounds += 1
        frontier = expand_refs(store, frontier, ref_hooks, live)
    return live, rounds, missing


class GarbageCollector:
    """Collector over one store.  Roots come from a BranchTable and/or a
    PinSet and/or explicit extra uids (the cluster dispatcher passes the
    union over all servlets as ``extra_roots``)."""

    def __init__(self, store, branches=None, pins: PinSet | None = None,
                 extra_roots=(), ref_hooks=()):
        self.store = store
        self.branches = branches
        self.pins = pins
        self.extra_roots = set(bytes(u) for u in extra_roots)
        self.ref_hooks = tuple(ref_hooks)

    def root_set(self) -> set[bytes]:
        roots = set(self.extra_roots)
        if self.branches is not None:
            roots |= self.branches.all_heads()
        if self.pins is not None:
            roots |= self.pins.uids()
        return roots

    def mark(self, roots=None) -> tuple[set[bytes], int, int]:
        return mark(self.store, self.root_set() if roots is None else roots,
                    self.ref_hooks)

    def sweep(self, live: set[bytes]) -> tuple[int, int]:
        """Delete everything stored but not live; returns
        (swept chunk count, reclaimed bytes).  Flushes afterwards so log
        tombstones are durable — a crash after the sweep must not replay
        swept chunks back to life."""
        dead = sorted(c for c in self.store.iter_cids() if c not in live)
        r0 = self.store.stats.reclaimed_bytes
        n = self.store.delete_many(dead) if dead else 0
        if n:
            self.store.flush()
        return n, self.store.stats.reclaimed_bytes - r0

    def collect(self) -> GCReport:
        roots = self.root_set()
        live, rounds, missing = self.mark(roots)
        # the sweep's flush feeds the durable-store compactor; report
        # the segment bytes it dropped alongside the logical reclaim
        c0 = self.store.stats.compacted_bytes
        swept, reclaimed = self.sweep(live)
        return GCReport(roots=len(roots), live_chunks=len(live),
                        swept_chunks=swept, reclaimed_bytes=reclaimed,
                        mark_rounds=rounds, missing_roots=missing,
                        compacted_bytes=(self.store.stats.compacted_bytes
                                         - c0))
