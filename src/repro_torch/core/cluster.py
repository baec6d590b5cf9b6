"""Distributed deployment (paper §4.1 Fig. 5, §4.6): master + request
dispatcher + servlets + chunk-storage pool, with hash-based two-layer
partitioning:

  1. dispatcher -> servlet : request-key hash;
  2. servlet   -> storage  : chunk cid hash (meta chunks stay local).

Because cids are cryptographic hashes, layer 2 spreads chunks uniformly
even under severely skewed key workloads (Fig. 15).  ``mode='1LP'``
reproduces the paper's one-layer baseline (all of a key's chunks stored on
its servlet's node).  Runs in-process; per-node byte/op counters stand in
for real placement, and POS-Tree construction rebalancing (§4.6.1) is a
work-queue transfer between servlets.
"""
from __future__ import annotations

import hashlib
import threading
from collections import deque
from dataclasses import dataclass, field

from . import chunk as ck
from .chunker import ChunkParams, DEFAULT_PARAMS
from .chunkstore import ChunkStore
from .db import ForkBase
from .locking import make_lock
from .. import obs
from ..errors import ConfigError, RoutingIndexMiss
from ..storage import BackendBase, resolve_cids
from ..storage.backend import group_by, put_via

__all__ = ["Cluster", "Node", "NodeStats", "RoutingIndexMiss"]


def _h(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "little")


@dataclass
class NodeStats:
    chunk_bytes: int = 0
    chunks: int = 0
    requests: int = 0
    build_work: int = 0      # POS-Tree construction work units (bytes)


def _delete_on_node(cluster: "Cluster", ni: int, cids,
                    stats=None) -> tuple[int, int]:
    """One node's share of a sweep: delete the chunks, debit the node's
    placement counters, drop master-index entries.  ``stats`` (optional,
    a routing store's) absorbs the delete/reclaim counters but is NEVER
    debited physical bytes: routing stats count what that servlet wrote,
    and the deleted chunk's writer is unknown, so a debit would skew the
    caller negative (physical truth lives in the node stores).  Returns
    (removed chunks, freed bytes)."""
    nd = cluster.nodes[ni]
    with nd.store_lock:
        d0 = nd.store.stats.deletes
        r0 = nd.store.stats.reclaimed_bytes
        nd.store.delete_many(cids)
        removed = nd.store.stats.deletes - d0
        freed = nd.store.stats.reclaimed_bytes - r0
    if stats is not None:
        stats.deletes += removed
        stats.reclaimed_bytes += freed
    nd.stats.chunks -= removed
    nd.stats.chunk_bytes -= freed
    with cluster._index_lock:
        for cid in cids:        # absent on the owner either way now
            cluster.index.pop(cid, None)
    return removed, freed


class _RoutingStore(BackendBase):
    """StorageBackend a servlet writes through: meta chunks pinned locally,
    data chunks placed by cid hash across the pool (2LP) or locally (1LP).
    Batched puts group chunks per target node — one put_many per node per
    batch, the cluster analogue of the §4.6.1 pipeline.  Reads go straight
    to the owning node (dispatcher fast path, §4.6)."""

    OBS_NAME = "routing"

    def __init__(self, cluster: "Cluster", home: int):
        super().__init__()
        self.cluster = cluster
        self.home = home

    def _owner(self, cid: bytes) -> int:
        """Hash placement (2LP) / home placement (1LP), walked past
        quarantined ring members: new chunks never land on a node the
        audit daemon has quarantined (enforcement, not advice)."""
        if self.cluster.mode == "1LP":
            return self.cluster._healthy_from(self.home)
        return self.cluster._healthy_from(
            _h(cid) % len(self.cluster.nodes))

    def _placement(self, raws):
        """owner_of for put batches: meta chunks pin to the home servlet
        (§4.6) — or its healthy ring successor while it is quarantined —
        and data chunks place by cid hash."""
        def owner(i, cid):
            if ck.chunk_type(raws[i]) == ck.META:
                return self.cluster._healthy_from(self.home)
            return self._owner(cid)
        return owner

    def _location(self, i, cid):
        """owner_of for read batches: master index only.  A missing
        entry is a typed ``RoutingIndexMiss`` — the old fallback to
        ``_owner(cid)`` sent the read to the hash owner, which holds no
        copy (meta chunks pin to their home servlet), so the failure
        surfaced as a generic miss from the WRONG node."""
        node = self.cluster.index.get(cid)
        if node is None:
            raise RoutingIndexMiss(bytes(cid))
        return node

    def _put_many_impl(self, raws, cids=None) -> list[bytes]:
        raws = [bytes(r) for r in raws]
        out = resolve_cids(raws, cids)
        st = self.stats
        st.put_batches += 1
        st.puts += len(raws)
        st.logical_bytes += sum(len(r) for r in raws)
        cluster = self.cluster
        for node, (_, cs, rs) in group_by(self._placement(raws),
                                          out, raws).items():
            n = cluster.nodes[node]
            with n.store_lock:
                _, new_chunks, new_bytes = put_via(st, n.store, rs, cs)
            n.stats.chunks += new_chunks
            n.stats.chunk_bytes += new_bytes
            with cluster._index_lock:
                for cid in cs:
                    cluster.index[cid] = node
                # A quarantine that landed after this batch's placement
                # snapshotted the index without these entries: queue them
                # here, under the same lock, or they would stay on the
                # quarantined node for good.  Placement only picks a
                # quarantined node when no healthy one is left, and then
                # re-replication has nowhere to go either.
                if (node in cluster.quarantined
                        and cluster._healthy_from(node) != node):
                    cluster._rerep_queue.extend((cid, node) for cid in cs)
        # listeners (GC write barrier) fire with NO routing locks held:
        # the collector lock nests inside servlet locks, never inside
        # index/store locks (canonical order: core.locking.LOCK_ORDER)
        self._notify_put(out)
        return out

    def _get_many_impl(self, cids) -> list[bytes]:
        st = self.stats
        st.get_batches += 1
        st.gets += len(cids)
        out: list[bytes | None] = [None] * len(cids)
        for node, (idx, cs, _) in group_by(self._location, cids).items():
            n = self.cluster.nodes[node]
            n.stats.requests += len(cs)
            with n.store_lock:
                raws = n.store.get_many(cs)
            for i, raw in zip(idx, raws):
                out[i] = raw
        return out  # type: ignore[return-value]

    def has_many(self, cids) -> list[bool]:
        out = [False] * len(cids)
        index = self.cluster.index
        located = [(i, cid, index.get(cid)) for i, cid in enumerate(cids)]
        groups: dict[int, list[tuple[int, bytes]]] = {}
        for i, cid, node in located:     # unindexed cids stay False
            if node is not None:
                groups.setdefault(node, []).append((i, cid))
        for node, pairs in groups.items():
            n = self.cluster.nodes[node]
            with n.store_lock:
                present = n.store.has_many([cid for _, cid in pairs])
            for (i, _), p in zip(pairs, present):
                out[i] = p
        return out

    def _delete_many_impl(self, cids) -> int:
        """Sweep fan-out by owning node; the master index and per-node
        placement counters shrink with the deleted chunks.  Unindexed
        cids are already gone — deleting them is a no-op, not a miss."""
        index = self.cluster.index
        groups: dict[int, list[bytes]] = {}
        for cid in cids:
            node = index.get(cid)
            if node is not None:
                groups.setdefault(node, []).append(cid)
        n = 0
        for node, cs in groups.items():
            n += _delete_on_node(self.cluster, node, cs, self.stats)[0]
        return n

    def iter_cids(self):
        """THIS servlet's share of the sweep/audit inventory: the chunks
        resident on its home node, streamed lazily from the node store
        (no cluster-wide list copy).  Per-servlet inventories are
        disjoint and union to the master index — a cluster-wide walk
        visits every chunk exactly once instead of N times.  ``len()``
        stays cluster-wide (the index size): the routing store is the
        servlet's window onto ONE shared pool, and dedup/put accounting
        (``put_via``) must see pool-wide existence."""
        return self.cluster.nodes[self.home].store.iter_cids()

    def __len__(self) -> int:
        return len(self.cluster.index)

    def flush(self) -> None:
        for n in self.cluster.nodes:
            with n.store_lock:
                n.store.flush()


@dataclass
class Node:
    store: ChunkStore
    stats: NodeStats
    servlet: ForkBase | None = None
    # Per-servlet mutual exclusion: held by the runtime's dispatcher
    # workers and by Cluster's public verbs around any touch of this
    # node's ForkBase (branch table, live tables, pins).  RLock so a
    # verb that is already inside the servlet lock (e.g. commit_epoch
    # folding into put) can re-enter.  Rank "servlet" — THE outermost
    # lock; the canonical order lives in core.locking.LOCK_ORDER.
    lock: threading.RLock = field(
        default_factory=lambda: make_lock("servlet"))
    # Cross-thread access to the node's chunk store (durable segment
    # stores mutate shared hot-tier/segment state on every op).  Rank
    # "store": innermost alongside "index" (see core.locking).
    store_lock: threading.RLock = field(
        default_factory=lambda: make_lock("store"))


class Cluster:
    """In-process ForkBase cluster."""

    def __init__(self, n_nodes: int = 4, mode: str = "2LP",
                 params: ChunkParams = DEFAULT_PARAMS,
                 verify: bool = False, *,
                 durable_root: str | None = None,
                 hot_bytes: int = 64 << 20,
                 segment_bytes: int = 4 << 20):
        if mode not in ("1LP", "2LP"):
            raise ConfigError(f"unknown placement mode {mode!r} "
                              "(expected '1LP' or '2LP')")
        self.mode = mode
        self.params = params
        self.durable_root = durable_root
        self.index: dict[bytes, int] = {}   # master's chunk location map
        # guards the master index and the quarantine/re-replication
        # state below; rank "index" — innermost alongside Node.store_lock
        # (canonical order in core.locking.LOCK_ORDER) — never held
        # across a store op or a listener callback
        self._index_lock = make_lock("index")
        # audit-enforced quarantine: node ids placement must route
        # around.  Populated via quarantine_node() (called by the audit
        # daemon at audit.quarantine time — enforcement works even with
        # REPRO_OBS=0 because it is a direct call, not an event tap).
        self.quarantined: set[int] = set()
        # re-replication backlog: (cid, source node) pairs snapshotted
        # when a node is quarantined, drained in budgeted slices by
        # rereplicate_step() (the MaintenanceDaemon's job)
        self._rerep_queue: deque[tuple[bytes, int]] = deque()
        self.rerep_done = 0      # chunks copied off quarantined nodes
        self.rerep_lost = 0      # chunks found corrupt/missing at rerep
        # one attestation/GC epoch fence for the whole cluster:
        # collections are cluster-wide, so servlet attestations pin into
        # (and collections consume from) the dispatcher's fence
        from ..gc.incremental import EpochFence
        self.gc_fence = EpochFence()
        self._audit_daemon = None
        if durable_root is None:
            stores = [ChunkStore(verify=verify) for _ in range(n_nodes)]
        else:
            # durable pool: each node's chunks live in a tiered segment
            # store under ``durable_root/node-XX``; reopening the same
            # root resumes the cluster (see ``sync``/``_restore_durable``)
            from ..storage.durable import open_durable
            stores = [open_durable(self._node_root(i), hot_bytes=hot_bytes,
                                   segment_bytes=segment_bytes,
                                   verify=verify)
                      for i in range(n_nodes)]
        self.nodes = [Node(store, NodeStats()) for store in stores]
        for i, node in enumerate(self.nodes):
            node.servlet = ForkBase(_RoutingStore(self, i), params)
        if durable_root is not None:
            self._restore_durable()
        # bloom spill path of the shared fence recovers cap-overflowed
        # pins by filtering the cluster-wide current heads
        self.gc_fence.heads_fn = self._all_heads

    # ---- durable pool (storage.durable) ----
    def _node_root(self, i: int) -> str:
        import os
        return os.path.join(self.durable_root, f"node-{i:02d}")

    def _heads_path(self, i: int) -> str:
        import os
        return os.path.join(self._node_root(i), "heads.json")

    def _restore_durable(self) -> None:
        """Resume a durable cluster: reload each servlet's branch heads
        from its last ``sync()`` snapshot and rebuild the master chunk
        location map by streaming every node store's cids (meta chunks
        are pinned to their home servlet, so the hash-placement fallback
        of ``_location`` alone would misroute them after a restart)."""
        import os
        for i, node in enumerate(self.nodes):
            path = self._heads_path(i)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    node.servlet.branches.restore(f.read())
            for cid in node.store.iter_cids():
                self.index[cid] = i
            node.stats.chunks = len(node.store)
            node.stats.chunk_bytes = node.store.stats.physical_bytes
            node.stats.build_work = node.stats.chunk_bytes

    def sync(self) -> None:
        """Cluster durability point: flush every node store (hot-tier
        write-back + segment fsync + GC-fed compaction) and atomically
        snapshot every servlet's branch heads.  After ``sync()``, a new
        ``Cluster(durable_root=...)`` over the same root resumes with
        bit-identical heads.  A plain flush when not durable."""
        for i, node in enumerate(self.nodes):
            node.store.flush()
            if self.durable_root is not None:
                from ..storage.durable import write_durably
                write_durably(self._heads_path(i),
                              node.servlet.branches.snapshot())

    def _all_heads(self) -> set[bytes]:
        """Cluster-wide current heads.  Takes each servlet lock one at
        a time (never two at once — no deadlock window with verbs that
        hold one servlet lock).  Callers (fence grace roots, collector
        begin) hold NO collector/fence lock here, per the lock order
        servlet ≺ collector ≺ {index, store}."""
        out: set[bytes] = set()
        for node in self.nodes:
            with node.lock:
                out |= node.servlet.branches.all_heads()
        return out

    # ---- dispatcher (layer 1) ----
    def _home_index(self, key) -> int:
        """Key-hash routing (hashed exactly once per dispatch)."""
        key = key.encode() if isinstance(key, str) else bytes(key)
        return _h(key) % len(self.nodes)

    def servlet_of(self, key: bytes) -> ForkBase:
        return self._node_of(key).servlet

    def _node_of(self, key) -> Node:
        i = self._home_index(key)
        self.nodes[i].stats.requests += 1
        return self.nodes[i]

    # ---- quarantine enforcement + re-replication ----
    def _healthy_from(self, start: int) -> int:
        """First non-quarantined ring member at or after ``start``
        (clockwise walk).  If EVERY node is quarantined the walk gives
        up and returns ``start`` — refusing all writes would wedge the
        cluster, and the audit findings already flag the whole pool."""
        q = self.quarantined
        if not q:                       # fast path: healthy cluster
            return start
        n = len(self.nodes)
        for j in range(n):
            ni = (start + j) % n
            if ni not in q:
                return ni
        return start

    def quarantine_node(self, ni: int, *, reason: str = "") -> int:
        """ENFORCE a quarantine (not just record it): placement stops
        routing new chunks to node ``ni`` (``_healthy_from`` walks past
        it) and its current chunk inventory — per the master index — is
        snapshotted into the re-replication backlog for budgeted
        draining by ``rereplicate_step``.  Idempotent.  Called by the
        audit daemon at the ``audit.quarantine`` emit point as a DIRECT
        call, so enforcement holds with REPRO_OBS=0.  Returns the
        number of chunks queued."""
        with self._index_lock:
            if ni in self.quarantined:
                return 0
            self.quarantined.add(ni)
            queued = [cid for cid, node in self.index.items()
                      if node == ni]
            self._rerep_queue.extend((cid, ni) for cid in queued)
        obs.emit("cluster.quarantine_enforced", node=f"node{ni}",
                 reason=reason, backlog=len(queued))
        return len(queued)

    def release_node(self, ni: int) -> None:
        """Lift a quarantine: ``ni`` rejoins placement.  Chunks already
        re-replicated stay where they landed (the index is truth);
        entries still queued for this node are dropped unprocessed."""
        with self._index_lock:
            if ni not in self.quarantined:
                return
            self.quarantined.discard(ni)
            self._rerep_queue = deque(
                e for e in self._rerep_queue if e[1] != ni)
        obs.emit("cluster.release_enforced", node=f"node{ni}")

    def rerep_backlog(self) -> int:
        with self._index_lock:
            return len(self._rerep_queue)

    def rereplicate_step(self, budget: int = 64) -> int:
        """Drain up to ``budget`` re-replication entries: copy each
        chunk off its quarantined source to the healthy hash-ring
        owner, redirect the master index, then drop the source copy
        (store delete only — no index pop, the entry now points at the
        destination).  A source copy that is missing or fails its
        content-hash check is instead *dropped from the index*:
        subsequent reads get the typed ``RoutingIndexMiss``, which is
        honest, rather than being routed to a node known to serve bad
        bytes.  Returns entries processed (0 ⇒ backlog empty)."""
        done = 0
        while done < budget:
            with self._index_lock:
                if not self._rerep_queue:
                    break
                cid, src = self._rerep_queue.popleft()
                cur = self.index.get(cid)
            done += 1
            if cur != src:
                continue            # swept or already moved
            sn = self.nodes[src]
            with sn.store_lock:
                raw = (sn.store.get_many([cid])[0]
                       if sn.store.has(cid) else None)
            if raw is None or resolve_cids([raw], None)[0] != cid:
                with self._index_lock:
                    if self.index.get(cid) == src:
                        self.index.pop(cid, None)
                self.rerep_lost += 1
                obs.emit("cluster.rerep_lost", node=f"node{src}",
                         cid=cid)
                continue
            dst = self._healthy_from(_h(cid) % len(self.nodes))
            if dst == src:          # whole pool quarantined: leave it
                continue
            dn = self.nodes[dst]
            with dn.store_lock:
                c0 = len(dn.store)
                p0 = dn.store.stats.physical_bytes
                dn.store.put_many([raw], [cid])
                dn.stats.chunks += len(dn.store) - c0
                dn.stats.chunk_bytes += dn.store.stats.physical_bytes - p0
            with self._index_lock:
                if self.index.get(cid) == src:
                    self.index[cid] = dst
            with sn.store_lock:
                d0 = sn.store.stats.deletes
                r0 = sn.store.stats.reclaimed_bytes
                sn.store.delete_many([cid])
                sn.stats.chunks -= sn.store.stats.deletes - d0
                sn.stats.chunk_bytes -= (sn.store.stats.reclaimed_bytes
                                         - r0)
            self.rerep_done += 1
        if done:
            obs.emit("cluster.rerep_step", processed=done,
                     backlog=self.rerep_backlog())
        return done

    def rereplicate(self, slice_budget: int = 256) -> int:
        """Drain the whole re-replication backlog (loops
        ``rereplicate_step``).  Returns total entries processed."""
        total = 0
        while True:
            n = self.rereplicate_step(slice_budget)
            if not n:
                return total
            total += n

    # public API mirrors ForkBase, routed per key.  Each verb holds the
    # key's home-servlet lock for its duration: ForkBase branch tables,
    # live tables, and pin sets are not internally synchronized, and the
    # async runtime (core.runtime) calls these from dispatcher workers.
    def put(self, key, value, branch=None, **kw):
        with obs.trace("cluster.put", key=key if isinstance(key, (bytes,
                       str)) else str(key)):
            nd = self._build_node_for(key, value)
            with nd.lock:
                return nd.servlet.put(key, value, branch, **kw)

    def get(self, key, branch=None, **kw):
        nd = self._node_of(key)
        with nd.lock:
            return nd.servlet.get(key, branch, **kw)

    def fork(self, key, ref, new_branch):
        nd = self._node_of(key)
        with nd.lock:
            return nd.servlet.fork(key, ref, new_branch)

    def merge(self, key, target, *refs, **kw):
        nd = self._node_of(key)
        with nd.lock:
            return nd.servlet.merge(key, target, *refs, **kw)

    def track(self, key, ref, dist_rng=(0, 1 << 30)):
        nd = self._node_of(key)
        with nd.lock:
            return nd.servlet.track(key, ref, dist_rng)

    def remove(self, key, branch):
        nd = self._node_of(key)
        with nd.lock:
            return nd.servlet.remove(key, branch)

    # ---- batched verbs (async runtime's coalesced dispatch) ----
    def put_batch(self, requests):
        """Coalesced multi-client put: ``requests`` is a sequence of
        (key, value, branch, kwargs) tuples.  Requests group by home
        servlet; each group commits through ONE shared WriteBuffer —
        one routing ``put_many`` fan-out per storage node per group
        instead of one per request (the §4.6.1 WriteBuffer idea lifted
        to the RPC layer).  Returns uids in request order."""
        groups: dict[int, list[tuple[int, tuple]]] = {}
        for i, req in enumerate(requests):
            groups.setdefault(self._home_index(req[0]), []).append(
                (i, req))
        out: list[bytes | None] = [None] * len(requests)
        for ni, batch in groups.items():
            nd = self.nodes[ni]
            nd.stats.requests += len(batch)
            with nd.lock:
                uids = nd.servlet.put_batch([r for _, r in batch])
            for (i, _), uid in zip(batch, uids):
                out[i] = uid
        return out

    def get_batch(self, requests):
        """Coalesced multi-client get: ``requests`` is a sequence of
        (key, branch, kwargs) tuples; per-servlet groups resolve heads
        then issue ONE batched chunk read.  Returns values in request
        order."""
        groups: dict[int, list[tuple[int, tuple]]] = {}
        for i, req in enumerate(requests):
            groups.setdefault(self._home_index(req[0]), []).append(
                (i, req))
        out: list = [None] * len(requests)
        for ni, batch in groups.items():
            nd = self.nodes[ni]
            nd.stats.requests += len(batch)
            with nd.lock:
                vals = nd.servlet.get_batch([r for _, r in batch])
            for (i, _), v in zip(batch, vals):
                out[i] = v
        return out

    # ---- live fast path (repro_torch.live), routed per key ----
    def live(self, key, branch=None, *, policy=None):
        """The key's home servlet's LiveTable — hot traffic is served
        off the flat path while the POS-Tree archive (and its 2LP chunk
        placement) is only touched at epoch folds."""
        nd = self._node_of(key)
        with nd.lock:
            return nd.servlet.live(key, branch, policy=policy)

    def commit_epoch(self, context: bytes = b"", *, attest: bool = False,
                     secret: bytes | None = None):
        """Cluster epoch boundary: fold every servlet's dirty live
        tables (each fold is one batched Put on its home servlet) and
        optionally attest per servlet.  Returns the per-servlet
        live.EpochReports.  Locks are taken one servlet at a time, so
        foreground verbs on other servlets proceed during the fold."""
        out = []
        for node in self.nodes:
            with node.lock:
                out.append(node.servlet.commit_epoch(
                    context, attest=attest, secret=secret))
        return out

    def commit_epoch_on(self, ni: int, context: bytes = b"", *,
                        attest: bool = False,
                        secret: bytes | None = None):
        """One servlet's epoch fold (the MaintenanceDaemon staggers
        folds across ticks so no single tick stalls every servlet)."""
        node = self.nodes[ni]
        with node.lock:
            return node.servlet.commit_epoch(context, attest=attest,
                                             secret=secret)

    # ---- garbage collection (cluster-wide) ----
    def _gc_roots_hooks(self, pins, extra_roots, extra_hooks):
        """Global root-set snapshot: union every servlet's TB/UB heads
        (branch-table copy per servlet) plus servlet pin sets, optional
        extra ``pins``, and caller-supplied roots/hooks — e.g. an
        external ForkBase sharing a routing store."""
        roots: set[bytes] = set(extra_roots)
        hooks: list = list(extra_hooks)
        for node in self.nodes:
            with node.lock:
                roots |= node.servlet.branches.all_heads()
                roots |= node.servlet.pins.uids()
                hooks.extend(h for h in node.servlet.gc_hooks
                             if h not in hooks)
        if pins is not None:
            roots |= pins.uids()
        return roots, hooks

    def gc(self, pins=None, extra_roots=(), extra_hooks=(), *,
           incremental: bool = False, budget: int = 256):
        """Cluster mark-and-sweep: the dispatcher unions every servlet's
        TB/UB heads (plus servlet pin sets, optional extra ``pins``, and
        any caller-supplied ``extra_roots``/``extra_hooks`` — e.g. an
        external ForkBase sharing a routing store) into one global root
        set, marks through the routing store — reads fan out to owning
        nodes via the master index, one batch per node per BFS level —
        then sweeps each node's *own* chunk store and the master index.
        ``incremental=True`` runs the same collection as an epoch of
        ``budget``-bounded slices (see ``incremental_gc``).
        The sweep deliberately bypasses the per-servlet routing-store
        stats: those count what each servlet wrote, and a chunk's writer
        is not recorded, so debiting any one servlet would skew its
        counters; physical reclamation shows up in the node stores'
        stats and the per-node placement counters."""
        from ..gc import GCReport, GarbageCollector
        if incremental:
            return self.incremental_gc(
                pins=pins, extra_roots=extra_roots,
                extra_hooks=extra_hooks).collect(budget)
        roots, hooks = self._gc_roots_hooks(pins, extra_roots, extra_hooks)
        # epoch fence: heads committed by attestations still in their
        # grace window survive STW collections too
        self.gc_fence.begin_epoch()
        roots |= self.gc_fence.grace_roots()
        gc = GarbageCollector(self.nodes[0].servlet.store,
                              extra_roots=roots, ref_hooks=hooks)
        live, rounds, missing = gc.mark()
        with self._index_lock:
            placed = list(self.index.items())
        by_node: dict[int, list[bytes]] = {}
        for cid, node in placed:
            if cid not in live:
                by_node.setdefault(node, []).append(cid)
        swept = reclaimed = compacted = 0
        for ni, cs in by_node.items():
            n, freed = _delete_on_node(self, ni, sorted(cs))
            swept += n
            reclaimed += freed
            nst = self.nodes[ni].store.stats
            c0 = nst.compacted_bytes
            self.nodes[ni].store.flush()  # durable tombstones if logged;
            #   on a durable store this flush feeds the segment compactor
            compacted += nst.compacted_bytes - c0
        self._rebase_build_work()
        report = GCReport(roots=len(roots), live_chunks=len(live),
                          swept_chunks=swept, reclaimed_bytes=reclaimed,
                          mark_rounds=rounds, missing_roots=missing,
                          compacted_bytes=compacted)
        obs.record_gc_report(report)
        obs.emit("gc.done", mode="stw", scope="cluster",
                 swept=swept, reclaimed_bytes=reclaimed)
        return report

    def incremental_gc(self, pins=None, extra_roots=(), extra_hooks=()):
        """Begin a cluster-wide incremental collection epoch and return
        its ``gc.IncrementalCollector`` (already in MARK).  The root set
        is an epoch-numbered snapshot — one branch-table copy per
        servlet taken here — so servlets keep committing during the
        distributed mark; write barriers are installed on EVERY
        servlet's routing store, and the sweep fans out per owning node
        in budget-bounded slices via the master index."""
        from contextlib import ExitStack
        from ..gc import IncrementalCollector
        # The root snapshot and the barrier installation must be ONE
        # atomic event w.r.t. committers: a put landing between the
        # branch-table copy and ``add_put_listener`` would move a head
        # whose chunks are neither rooted nor barriered — white to the
        # mark, condemned by the freeze, swept while fully live.  Every
        # servlet lock is held (ascending order; all other verbs take at
        # most one at a time, so the ordered sweep cannot deadlock) for
        # the duration of ``begin()`` — a bounded pause (root copy plus
        # one ``has_many``), not the mark itself.
        with ExitStack() as stack:
            for node in self.nodes:
                stack.enter_context(node.lock)
            roots, hooks = self._gc_roots_hooks(pins, extra_roots,
                                                extra_hooks)
            col = IncrementalCollector(
                self.nodes[0].servlet.store, extra_roots=roots,
                ref_hooks=hooks,
                barrier_stores=[n.servlet.store for n in self.nodes],
                inventory_fn=self._index_snapshot,
                sweep_fn=self._sweep_slice,
                flush_fn=self._flush_nodes,
                on_done=lambda report: self._rebase_build_work(),
                fence=self.gc_fence)
            col.begin()
            for node in self.nodes:  # fork-from-uid / pin root barriers
                node.servlet._track_collector(col)
        return col

    def _index_snapshot(self) -> list[bytes]:
        with self._index_lock:
            return list(self.index)

    def _sweep_slice(self, cids) -> tuple[int, int]:
        """One bounded sweep slice, fanned out per owning node."""
        with self._index_lock:
            located = [(cid, self.index.get(cid)) for cid in cids]
        by_node: dict[int, list[bytes]] = {}
        for cid, ni in located:
            if ni is not None:
                by_node.setdefault(ni, []).append(cid)
        swept = freed = 0
        for ni, cs in by_node.items():
            n, f = _delete_on_node(self, ni, sorted(cs))
            swept += n
            freed += f
        return swept, freed

    def _flush_nodes(self) -> None:
        for node in self.nodes:
            node.store.flush()       # durable tombstones if logged

    def _rebase_build_work(self) -> None:
        """GC-aware rebalancing (ROADMAP): after a collection, re-anchor
        the construction-pressure counters on the post-GC LIVE byte
        distribution instead of gross bytes ever written — a node whose
        data was mostly collected must stop repelling new construction
        work, and a node dense with live chunks must keep delegating."""
        for n in self.nodes:
            n.stats.build_work = max(0, n.stats.chunk_bytes)

    # ---- audit RPC verbs (proof subsystem) ----
    def attest(self, context: bytes = b"", secret: bytes | None = None):
        """Dispatcher attestation: one Merkle commitment per servlet's
        branch table plus a cluster root over the servlet roots — a
        light client pins the cluster root and drills into any node.
        Returns (cluster Attestation, per-servlet attestations)."""
        from ..proof.attest import (Attestation, leaf_hash, merkle_root,
                                    sign)
        from ..proof.delta import pack_epoch
        atts = []
        for i, nd in enumerate(self.nodes):
            with nd.lock:
                atts.append(nd.servlet.attest(
                    context=bytes(context) + b"|node%d" % i,
                    secret=secret))
        cluster_att = Attestation(
            merkle_root([leaf_hash(a.root) for a in atts]),
            len(atts), pack_epoch(self.gc_fence.epoch, bytes(context)))
        return ((sign(cluster_att, secret) if secret is not None
                 else cluster_att), atts)

    def audit(self, sample: int = 64, seed: int = 0,
              secret: bytes | None = None):
        """Cluster-wide audit: master-index placement spot checks,
        per-servlet head/membership/lineage proof verification, and
        key-routing divergence — reported per offending node."""
        from ..proof.audit import Auditor
        return Auditor(sample=sample, seed=seed).audit_cluster(
            self, secret=secret)

    def audit_daemon(self, *, sample: int = 32, seed: int = 0,
                     secret: bytes | None = None, base_interval: int = 1,
                     max_interval: int = 64):
        """The persistent continuous-audit daemon for this cluster
        (proof.AuditDaemon): call ``tick(budget)`` from the serving
        loop.  One daemon per cluster — repeated calls return it (pass
        different knobs by constructing proof.AuditDaemon directly)."""
        from ..proof.audit import AuditDaemon
        if self._audit_daemon is None:
            self._audit_daemon = AuditDaemon(
                self, sample=sample, seed=seed, secret=secret,
                base_interval=base_interval, max_interval=max_interval)
        return self._audit_daemon

    def audit_tick(self, budget: int = 1):
        """One continuous-audit tick (see ``audit_daemon``): audits at
        most ``budget`` due targets and returns the tick's AuditReport."""
        return self.audit_daemon().tick(budget)

    # ---- async runtime (core.runtime) ----
    def runtime(self, config=None) -> "object":
        """An event-driven ClusterRuntime over this cluster: bounded
        per-servlet queues with obs-driven admission control, coalesced
        cross-client dispatch, and a time-paced MaintenanceDaemon (see
        core.runtime).  A new runtime per call — callers own start/stop."""
        from .runtime import ClusterRuntime
        return ClusterRuntime(self, config)

    # ---- §4.6.1 construction rebalancing ----
    def _build_node_for(self, key, value) -> Node:
        """POS-Tree construction is CPU-heavy; an overloaded servlet locks
        the branch table and delegates chunking to the least-loaded peer,
        embedding the returned root cid itself.  We model load with the
        build_work counter; the branch-table update always happens on the
        key's home servlet (whose Node is returned here)."""
        owner = self.nodes[self._home_index(key)]
        owner.stats.requests += 1             # one dispatch, counted once
        size = _value_size(value)
        hi = max(self.nodes, key=lambda n: n.stats.build_work)
        lo = min(self.nodes, key=lambda n: n.stats.build_work)
        if (owner is hi and owner.stats.build_work >
                2 * max(1, lo.stats.build_work) and size > 0):
            lo.stats.build_work += size        # delegated construction
        else:
            owner.stats.build_work += size
        return owner

    # ---- stats ----
    def observe(self) -> dict:
        """Cluster-wide observability snapshot: the global registry /
        event journal / GC history plus every node store's StoreStats
        (and their cluster-wide rollup under ``stores.cluster``),
        per-node placement counters, and the quarantine set.  Pulled at
        snapshot time — node stats are read, never re-counted into
        registry counters.  JSON-safe."""
        from ..storage.backend import StoreStats
        rollup = StoreStats()
        stores = {}
        for i, nd in enumerate(self.nodes):
            rollup.merge(nd.store.stats)
            stores[f"node{i}"] = nd.store.stats
        stores["cluster"] = rollup
        quarantined = (sorted(self._audit_daemon.quarantined)
                       if self._audit_daemon is not None else [])
        extra = {"cluster": {
            "mode": self.mode,
            "nodes": [{"chunks": n.stats.chunks,
                       "chunk_bytes": n.stats.chunk_bytes,
                       "requests": n.stats.requests,
                       "build_work": n.stats.build_work}
                      for n in self.nodes],
            "index_size": len(self.index),
            "gc_epoch": self.gc_fence.epoch,
            "quarantined": quarantined,
            # enforcement view (routing layer), distinct from the audit
            # daemon's finding view above
            "quarantined_enforced": sorted(self.quarantined),
            "rerep_backlog": self.rerep_backlog(),
            "rerep_done": self.rerep_done,
            "rerep_lost": self.rerep_lost,
        }}
        return obs.snapshot(stores=stores, extra=extra)

    def storage_distribution(self) -> list[int]:
        return [n.stats.chunk_bytes for n in self.nodes]

    def build_distribution(self) -> list[int]:
        return [n.stats.build_work for n in self.nodes]


def _value_size(value) -> int:
    if hasattr(value, "read"):
        try:
            return len(value)
        except Exception:
            return 0
    if hasattr(value, "encode") and not isinstance(value, str):
        return len(value.encode())
    if isinstance(value, (bytes, bytearray, str)):
        return len(value)
    return 0
