"""ForkBase connector — the public API (paper Table 1 + guarded Put §4.5.1
+ Diff §3.2) with chunk GC (stop-the-world and incremental), retention
(``truncate_history``), ``observe()``, the proof verbs (prove / attest /
audit) and the live tier (``live`` / ``commit_epoch``).

Both fork semantics are first-class:
  * Fork-on-Demand  (FoD): named (tagged) branches, explicit Fork/Merge;
  * Fork-on-Conflict (FoC): ``Put(key, base_uid, value)`` against an already
    derived base implicitly forks; the UB-table tracks the resulting
    untagged heads and ``Merge(key, uid1, uid2, ...)`` reconciles them.

``from_state`` builds an engine over carried-over state: the chunks of a
store (cid -> raw bytes) and a ``BranchTable.snapshot()`` blob, both plain
bytes, so a reference engine's state can be served by this one and back.
"""
from __future__ import annotations

import os
from typing import Iterable, Mapping

from . import chunk as ck
from . import merge as mg
from .branch import (DEFAULT_BRANCH, BranchTable, GuardFailed,
                     NoSuchRef)
from .chunker import ChunkParams, DEFAULT_PARAMS
from .chunkstore import ChunkStore
from .. import obs
from ..storage import StorageBackend, WriteBuffer
from .fobject import (CHUNKABLE_TYPES, FObject, load_fobject, make_fobject)
from .postree import POSTree
from .types import (CHUNKABLE_CLASSES, FBlob, FInt, FList, FMap, FSet,
                    FString, FTuple, PRIMITIVE_CLASSES)

#: Blob roots an engine remembers as cut by its params (oldest dropped).
CUT_ROOTS = 1 << 16


class TypeNotMatch(Exception):
    pass


class ValueHandle:
    """Typed view over a Get result (paper Fig. 4: value.Blob() etc.)."""

    def __init__(self, db: "ForkBase", obj: FObject):
        self.db = db
        self.obj = obj

    @property
    def type(self) -> int:
        return self.obj.type

    @property
    def uid(self) -> bytes:
        return self.obj.uid

    def _chunkable(self, kind: int):
        if self.obj.type != kind:
            raise TypeNotMatch(self.obj.type_name())
        tree = POSTree.from_root(
            self.db.store, kind, self.obj.data, self.db.params,
            cut_by_params=self.obj.data in self.db._cut_roots)
        return CHUNKABLE_CLASSES[kind].from_tree(tree)

    def blob(self) -> FBlob:
        return self._chunkable(ck.BLOB)

    def list(self) -> FList:
        return self._chunkable(ck.LIST)

    def map(self) -> FMap:
        return self._chunkable(ck.MAP)

    def set(self) -> FSet:
        return self._chunkable(ck.SET)

    def primitive(self):
        if self.obj.type not in PRIMITIVE_CLASSES:
            raise TypeNotMatch(self.obj.type_name())
        return PRIMITIVE_CLASSES[self.obj.type].decode(self.obj.data)

    def string(self) -> FString:
        if self.obj.type != FString.TYPE:
            raise TypeNotMatch(self.obj.type_name())
        return FString.decode(self.obj.data)

    def tuple(self) -> FTuple:
        if self.obj.type != FTuple.TYPE:
            raise TypeNotMatch(self.obj.type_name())
        return FTuple.decode(self.obj.data)

    def integer(self) -> FInt:
        if self.obj.type != FInt.TYPE:
            raise TypeNotMatch(self.obj.type_name())
        return FInt.decode(self.obj.data)


class ForkBase:
    """Embedded single-servlet engine (one servlet + one chunk storage,
    §4.1).  cluster.Cluster wires several of these behind a dispatcher."""

    def __init__(self, store: StorageBackend | None = None,
                 params: ChunkParams = DEFAULT_PARAMS, *,
                 verify_get: bool = False,
                 durable_root: str | None = None,
                 hot_bytes: int = 64 << 20,
                 segment_bytes: int = 4 << 20):
        # durable mode: chunks live in the tiered segment store under
        # ``durable_root`` and branch heads are reloaded from the last
        # ``sync()`` snapshot — reopening the same root resumes the
        # engine with bit-identical heads
        if store is None and durable_root is not None:
            from ..storage.durable import open_durable
            store = open_durable(durable_root, hot_bytes=hot_bytes,
                                 segment_bytes=segment_bytes,
                                 verify=verify_get)
        self._durable_root = durable_root
        self.store = store if store is not None else ChunkStore()
        self.params = params
        # roots of the blobs this engine committed whose leaves ``params``
        # cut (the newest CUT_ROOTS): a blob read back from one splices
        # each cluster of its edits on its own (POSTree.splice_bytes)
        self._cut_roots: dict[bytes, None] = {}
        # verify-on-get: every Get re-hashes the meta chunk against its
        # uid (per-call ``verify=`` overrides; checks count in StoreStats)
        self.verify_get = verify_get
        self.branches = BranchTable()
        if durable_root is not None:
            head_path = _heads_path(durable_root)
            if os.path.exists(head_path):
                with open(head_path, "rb") as f:
                    self.branches.restore(f.read())
        # explicit GC roots: in-flight readers / retention holds pin the
        # uids they need across a concurrent collect(); pinning mid-
        # collection fires the incremental root barrier
        from ..gc.incremental import EpochFence
        from ..gc.pins import PinSet
        self.pins = PinSet(on_pin=self._gc_root_barrier)
        # attestation/GC epoch handshake: attest() pins the heads it
        # commits to; collections root pins still in the grace window
        # (heads_fn backs the fence's bloom spill path: pins past the
        # memory cap are recovered by filtering current heads)
        self.gc_fence = EpochFence()
        self.gc_fence.heads_fn = self.branches.all_heads
        # live tables (flat-state fast path, repro_torch.live): one per
        # (key, branch) head, folded into the archive at epoch
        # boundaries — see live() / commit_epoch()
        self._live: dict = {}
        # attest pin delta: keys whose heads moved since the last
        # attest; the first attest of a fence epoch pins the full head
        # baseline, subsequent ones pin only these keys' heads — O(k)
        self._attest_dirty: set[bytes] = set()
        self._attest_pin_epoch: int | None = None
        self.branches.add_listener(self._on_head_mutation)
        # incremental attestation state (proof.delta), built lazily on
        # the first attest()/prove_head()
        self._delta_attestor = None
        # per-root audit-path cache for prove_member/prove_absence
        from ..proof.membership import ProofCache
        self.proof_cache = ProofCache()
        # application-level link extractors (gc.mark ref_hooks): layers
        # that embed cids inside opaque values (ckpt manifests) register
        # here so gc() can trace through them
        self.gc_hooks: list = []
        # in-flight incremental collections this engine must barrier for
        # (store-level put barriers are installed by the collector; this
        # registry carries the *root* barrier: fork-from-uid, new pins)
        self.gc_collectors: list = []

    # ------------------------------------------------------------- put
    def _commit_value(self, value, store=None) -> tuple[int, bytes]:
        """Returns (object type, data field bytes)."""
        if store is None:
            store = self.store
        if hasattr(value, "commit"):          # chunkable handle
            root = value.commit(store)
            tree = value.tree
            if (value.TYPE == FBlob.TYPE and tree.cut_by_params
                    and tree.params == self.params):
                self._cut_roots.pop(root, None)
                self._cut_roots[root] = None
                if len(self._cut_roots) > CUT_ROOTS:
                    del self._cut_roots[next(iter(self._cut_roots))]
            return value.TYPE, root
        if hasattr(value, "encode"):          # primitive
            return value.TYPE, value.encode()
        if isinstance(value, (bytes, bytearray, str)):
            v = value.encode() if isinstance(value, str) else bytes(value)
            return FString.TYPE, v
        raise TypeError(f"unsupported value: {type(value)}")

    def put(self, key: bytes, value, branch: str | None = None, *,
            base_uid: bytes | None = None, context: bytes = b"",
            guard_uid: bytes | None = None) -> bytes:
        """M3 (branch put), M4 (FoC put on a base version), guarded put."""
        with obs.trace("engine.put", key=key):
            return self._put_inner(key, value, branch, base_uid=base_uid,
                                   context=context, guard_uid=guard_uid)

    def _put_inner(self, key, value, branch, *, base_uid, context,
                   guard_uid) -> bytes:
        key = _k(key)
        if base_uid is not None:              # M4: fork-on-conflict path
            bases: tuple[bytes, ...] = (base_uid,)
            base_depth = load_fobject(self.store, base_uid).depth
        else:
            branch = branch or DEFAULT_BRANCH
            head = self.branches.head(key, branch)
            if guard_uid is not None and head != guard_uid:
                raise GuardFailed(branch)
            bases = (head,) if head else ()
            base_depth = (load_fobject(self.store, head).depth
                          if head else -1)
        # batched chunk pipeline (§4.6.1): every chunk of this value —
        # POS-Tree leaves, index nodes, the meta chunk — accumulates in
        # one WriteBuffer and hits the store as a single put_many.
        batch = WriteBuffer(self.store)
        t, data = self._commit_value(value, batch)
        obj = make_fobject(batch, t, key, data, bases, context,
                           base_depth)
        batch.flush()
        self.branches.on_new_version(key, obj.uid, bases,
                                     foc=base_uid is not None)
        if base_uid is None:
            self.branches.set_head(key, branch, obj.uid)
        return obj.uid

    # ------------------------------------------------------------- get
    def get(self, key: bytes, branch: str | None = None, *,
            uid: bytes | None = None,
            verify: bool | None = None) -> ValueHandle | None:
        """M1 (branch get) / M2 (version get).  ``verify`` (default: the
        engine's ``verify_get``) re-hashes the meta chunk against the uid
        and raises TamperedChunk on mismatch.

        A get carries no span: it is the O(10µs) hot path the
        obs-overhead gate protects; the work of reading a value is timed
        where it happens, in the ``tree.load`` and ``tree.read`` spans."""
        key = _k(key)
        if uid is None:
            uid = self.branches.head(key, branch or DEFAULT_BRANCH)
            if uid is None:
                return None
        verify = self.verify_get if verify is None else verify
        return ValueHandle(self, load_fobject(self.store, uid,
                                              verify=verify))

    # -------------------------------------------------- batched verbs
    def put_batch(self, requests) -> list[bytes]:
        """Coalesced multi-request put (the async runtime's dispatch
        unit): ``requests`` are ``(key, value)``, ``(key, value,
        branch)`` or ``(key, value, branch, kwargs)`` tuples.  Plain
        branch puts commit through ONE shared WriteBuffer — every
        value's tree chunks and meta chunk across the whole batch hit
        the store as a single put_many (the §4.6.1 chunk pipeline
        lifted to the request layer) — and same-key-same-branch
        requests chain within the batch exactly as sequential puts
        would (the buffer's overlay serves the base version's meta
        chunk before flush).  Head updates publish only after the
        flush, so a reader never sees a head whose chunks are still
        buffered.  Guarded / fork-on-conflict requests (``guard_uid``,
        ``base_uid``) need the real branch table: the batch flushes
        around them and they take the single-put path, order
        preserved.  Returns uids in request order."""
        out: list[bytes] = []
        with obs.trace("engine.put_batch", requests=len(requests)):
            batch: WriteBuffer | None = None
            heads: dict[tuple[bytes, str], bytes] = {}
            pending: list[tuple[bytes, str, bytes, tuple]] = []

            def _flush() -> None:
                nonlocal batch
                if batch is None:
                    return
                batch.flush()
                for key, branch, uid, bases in pending:
                    self.branches.on_new_version(key, uid, bases)
                    self.branches.set_head(key, branch, uid)
                pending.clear()
                heads.clear()
                batch = None

            for req in requests:
                key, value = req[0], req[1]
                branch = (req[2] if len(req) > 2 and req[2] is not None
                          else DEFAULT_BRANCH)
                kw = dict(req[3]) if len(req) > 3 and req[3] else {}
                if (kw.get("base_uid") is not None
                        or kw.get("guard_uid") is not None):
                    _flush()
                    out.append(self._put_inner(
                        key, value, branch,
                        base_uid=kw.get("base_uid"),
                        context=kw.get("context", b""),
                        guard_uid=kw.get("guard_uid")))
                    continue
                key = _k(key)
                if batch is None:
                    batch = WriteBuffer(self.store)
                head = heads.get((key, branch))
                if head is None:
                    head = self.branches.head(key, branch)
                bases = (head,) if head else ()
                base_depth = (load_fobject(batch, head).depth
                              if head else -1)
                t, data = self._commit_value(value, batch)
                obj = make_fobject(batch, t, key, data, bases,
                                   kw.get("context", b""), base_depth)
                heads[(key, branch)] = obj.uid
                pending.append((key, branch, obj.uid, bases))
                out.append(obj.uid)
            _flush()
        return out

    def get_batch(self, requests) -> list:
        """Coalesced multi-request get: ``requests`` are ``(key,)``,
        ``(key, branch)`` or ``(key, branch, kwargs)`` tuples.  Heads
        resolve first, then every requested meta chunk loads in ONE
        ``store.get_many`` (one routing fan-out per storage node
        instead of one per request).  Requests needing verify-on-get
        take the single-get path.  Returns ValueHandle-or-None in
        request order."""
        parsed = []
        for req in requests:
            key = req[0]
            branch = req[1] if len(req) > 1 else None
            kw = req[2] if len(req) > 2 and req[2] else {}
            parsed.append((key, branch, kw))
        out: list = [None] * len(parsed)
        fetch: list[tuple[int, bytes]] = []
        for i, (key, branch, kw) in enumerate(parsed):
            verify = kw.get("verify")
            verify = self.verify_get if verify is None else verify
            if verify:                     # verify re-hashes per chunk
                out[i] = self.get(key, branch, uid=kw.get("uid"),
                                  verify=True)
                continue
            uid = kw.get("uid")
            if uid is None:
                uid = self.branches.head(_k(key),
                                         branch or DEFAULT_BRANCH)
                if uid is None:
                    continue
            fetch.append((i, bytes(uid)))
        if fetch:
            raws = self.store.get_many([uid for _, uid in fetch])
            for (i, uid), raw in zip(fetch, raws):
                out[i] = ValueHandle(self, FObject.deserialize(raw, uid))
        return out

    # ------------------------------------------------- live fast path
    def _on_head_mutation(self, key: bytes) -> None:
        """Branch-table listener: feeds the attest pin delta and marks
        this key's live tables stale (an external put / merge / fork
        moved a head under them)."""
        key = bytes(key)
        self._attest_dirty.add(key)
        if self._live:
            for (k, _b), t in self._live.items():
                if k == key:
                    t._mark_stale()

    def live(self, key: bytes, branch: str | None = None, *, policy=None):
        """Flat-state fast path (repro_torch.live): a per-(key, branch)
        ``LiveTable`` absorbing puts and serving gets in O(1), folded
        into the POS-Tree archive at epoch boundaries (``fold()`` /
        ``commit_epoch()`` / the table's EpochPolicy thresholds).
        Repeated calls return the same table.  Direct ``put``s on the
        same (key, branch) stay legal: the table revalidates against
        the moved head and its dirty overlay reapplies on top at the
        next fold (last-writer-wins, as two successive puts would)."""
        from ..live.table import LiveTable
        key = _k(key)
        branch = branch or DEFAULT_BRANCH
        t = self._live.get((key, branch))
        if t is None:
            t = (LiveTable(self, key, branch, policy=policy)
                 if policy is not None else LiveTable(self, key, branch))
            self._live[(key, branch)] = t
        return t

    def commit_epoch(self, context: bytes = b"", *, attest: bool = False,
                     secret: bytes | None = None):
        """Epoch boundary: fold every dirty live table into the archive
        (one batched Put per table) and publish the folded roots under
        the EpochFence handshake — each new head is pinned at the
        current collection epoch and forwarded to in-flight collections
        exactly like an attested head, so no sweep can touch a chunk a
        fold just referenced before the fold's proofs are servable.
        With ``attest=True`` the epoch closes with a delta attestation
        committing to the folded heads.  Returns a live.EpochReport."""
        from ..live.table import EpochReport
        rep = EpochReport()
        for t in list(self._live.values()):
            if t.dirty_count:
                rep.folds.append(t.fold(context=context))
        folded = rep.folded_uids
        if folded:
            cluster = getattr(self.store, "cluster", None)
            fence = (cluster.gc_fence if cluster is not None
                     else self.gc_fence)
            fence.pin(folded)
            self._gc_attest_fence(folded)
        if attest:
            rep.attestation = self.attest(context=context, secret=secret)
        return rep

    def _live_fold_key(self, key: bytes) -> None:
        """Fork/merge of a dirty head folds first: the archive must hold
        the state the new branch (or the merge input) is derived from."""
        if self._live:
            for (k, _b), t in list(self._live.items()):
                if k == key and t.dirty_count:
                    t.fold()

    # ----------------------------------------------------------- views
    def list_keys(self) -> list[bytes]:                      # M8
        return self.branches.keys()

    def list_tagged_branches(self, key: bytes) -> dict[str, bytes]:  # M9
        return self.branches.tagged(_k(key))

    def list_untagged_branches(self, key: bytes) -> list[bytes]:     # M10
        return self.branches.untagged(_k(key))

    # ----------------------------------------------------------- forks
    def fork(self, key: bytes, ref: str | bytes, new_branch: str) -> None:
        """M11 (from branch) / M12 (from uid)."""
        key = _k(key)
        self._live_fold_key(key)      # fork of a dirty head folds first
        uid = (self.branches.head(key, ref) if isinstance(ref, str)
               else bytes(ref))
        if uid is None or (not isinstance(ref, str)
                           and not self.store.has(uid)):
            raise NoSuchRef(ref)   # a dangling tag would poison GC roots
        # root barrier: tagging an arbitrary uid mid-collection re-roots
        # its subgraph — it must be shaded (mark) or rescued (sweep)
        self._gc_root_barrier(uid)
        self.branches.fork(key, new_branch, uid)

    def rename(self, key: bytes, old: str, new: str) -> None:   # M13
        key = _k(key)
        self.branches.rename(key, old, new)
        t = self._live.pop((key, old), None)
        if t is not None:             # live table follows its branch name
            t.branch = new
            self._live[(key, new)] = t

    def remove(self, key: bytes, branch: str) -> None:          # M14
        key = _k(key)
        self.branches.remove(key, branch)
        # the branch's unfolded live delta dies with the branch, exactly
        # like its unswept archive chunks
        self._live.pop((key, branch), None)

    # ------------------------------------------------------- durability
    def sync(self) -> None:
        """Durability point for a durable-root engine: flush the store
        (demote the hot tier, fsync segments, run GC-fed compaction)
        and atomically snapshot the branch heads — after ``sync()``
        returns, reopening the same root resumes with bit-identical
        heads and every chunk reachable from them.  A no-op flush on a
        non-durable engine."""
        with obs.trace("engine.sync"):
            self.store.flush()
            if self._durable_root is not None:
                from ..storage.durable import write_durably
                write_durably(_heads_path(self._durable_root),
                              self.branches.snapshot())

    # ---------------------------------------------------- observability
    def observe(self) -> dict:
        """Engine observability snapshot: the global registry / event
        journal / GC history plus this engine's StoreStats (pulled at
        snapshot time, never re-counted) and live-table aggregates.
        JSON-safe — ``json.dumps(db.observe())`` round-trips."""
        live = {"tables": len(self._live), "dirty_keys": 0, "folds": 0,
                "fold_seconds": 0.0}
        for t in self._live.values():
            live["dirty_keys"] += t.dirty_count
            live["folds"] += t.stats.folds
            live["fold_seconds"] += t.stats.fold_seconds
        extra = {"engine": {
            "keys": len(self.branches.keys()),
            "pins": len(self.pins.uids()),
            "gc_epoch": self.gc_fence.epoch,
            "live": live,
        }}
        return obs.snapshot(stores={"store": self.store.stats},
                            extra=extra)

    # ---------------------------------------------------- space reclaim
    def gc(self, *, extra_roots: Iterable[bytes] = (),
           incremental: bool = False, budget: int = 256):
        """Mark-and-sweep: everything reachable from the TB/UB heads of
        every key (plus ``self.pins`` and ``extra_roots``) survives; the
        rest is removed via the backend's ``delete_many``.  Returns a
        ``gc.GCReport``.

        ``incremental=True`` runs the same collection as a tri-color
        epoch in ``budget``-bounded slices (``gc.IncrementalCollector``)
        — every pause is O(budget) chunks instead of O(DAG); use
        ``incremental_gc()`` to interleave the slices with your own
        traffic.

        When the store is a cluster routing store, its sweep inventory
        spans the whole cluster, so the collection must be the
        cluster's: this delegates to ``Cluster.gc`` (contributing this
        engine's own heads, pins and hooks), which unions every
        servlet's roots and sweeps each node's store directly.  A
        single-servlet ``gc()`` is therefore exactly as safe as
        ``Cluster.gc()``, and no servlet's write-side routing counters
        are skewed by deleting chunks another servlet wrote."""
        from ..gc import GarbageCollector
        cluster = getattr(self.store, "cluster", None)
        if cluster is not None:
            roots = (set(extra_roots) | self.branches.all_heads()
                     | self.pins.uids())
            return cluster.gc(extra_roots=roots, extra_hooks=self.gc_hooks,
                              incremental=incremental, budget=budget)
        if incremental:
            return self.incremental_gc(extra_roots=extra_roots).collect(
                budget)
        # STW collections honor the attestation epoch fence too: heads
        # committed by a recent attestation stay provable for one more
        # epoch regardless of how the collection is driven
        self.gc_fence.begin_epoch()
        roots = set(extra_roots) | self.gc_fence.grace_roots()
        report = GarbageCollector(self.store, branches=self.branches,
                                  pins=self.pins, extra_roots=roots,
                                  ref_hooks=self.gc_hooks).collect()
        obs.record_gc_report(report)
        obs.emit("gc.done", mode="stw", scope="engine",
                 swept=report.swept_chunks,
                 reclaimed_bytes=report.reclaimed_bytes)
        return report

    def incremental_gc(self, *, extra_roots: Iterable[bytes] = ()):
        """Begin an incremental collection epoch and return its
        ``gc.IncrementalCollector`` (already in MARK, barriers
        installed): interleave ``step(budget)`` with your own commits;
        every put/merge/fork/pin in between is barriered, so no chunk
        reachable from any head or pin is ever swept.  On a cluster
        routing store this is the cluster's collection (see ``gc``)."""
        from ..gc import IncrementalCollector
        cluster = getattr(self.store, "cluster", None)
        if cluster is not None:
            roots = (set(extra_roots) | self.branches.all_heads()
                     | self.pins.uids())
            col = cluster.incremental_gc(extra_roots=roots,
                                         extra_hooks=self.gc_hooks)
            # an external engine sharing a routing store is a committer
            # too: its fork-from-uid / pin root barriers must reach the
            # cluster's collection (servlets are registered by Cluster)
            self._track_collector(col)
            return col
        col = IncrementalCollector(self.store, branches=self.branches,
                                   pins=self.pins, extra_roots=extra_roots,
                                   ref_hooks=self.gc_hooks,
                                   fence=self.gc_fence)
        col.begin()
        self._track_collector(col)
        return col

    def _track_collector(self, col) -> None:
        """Register an in-flight collection for root barriers, dropping
        finished epochs so back-to-back collections don't accumulate."""
        self.gc_collectors = [c for c in self.gc_collectors
                              if c.active and c is not col]
        self.gc_collectors.append(col)

    def _gc_root_barrier(self, uid: bytes) -> None:
        """Forward a re-rooting event (fork-from-uid, new pin) to every
        in-flight incremental collection; finished ones drop out."""
        if not self.gc_collectors:
            return
        self.gc_collectors = [c for c in self.gc_collectors if c.active]
        for c in self.gc_collectors:
            c.root_barrier(uid)

    def truncate_history(self, key: bytes, branch: str,
                         keep_uids: "list[bytes]",
                         base_uid: bytes | None = None
                         ) -> dict[bytes, bytes]:
        """Destructive retention primitive: rewrite ``branch``'s version
        chain to exactly ``keep_uids`` (newest first, as returned by
        ``track``), relinking each kept version's ``bases`` to the
        previous kept one; the oldest links to ``base_uid`` if given
        (the anchor: an untouched ancestor, e.g. history shared with
        another branch) and otherwise becomes a root.  Kept versions get
        new uids (the meta chunk changes; hash-chain tamper evidence is
        preserved over the *retained* chain); retired versions become
        unreachable, so the next ``gc()`` sweeps them.  The rewritten
        chain is linear — merge second-parents above the anchor are
        dropped, which is what makes their subtrees collectable.
        Returns {old uid: new uid}."""
        key = _k(key)
        if not keep_uids:
            raise NoSuchRef(branch)
        old_head = self.branches.head(key, branch)
        if old_head is None:
            raise NoSuchRef(branch)
        mapping: dict[bytes, bytes] = {}
        prev = base_uid
        base_depth = (load_fobject(self.store, base_uid).depth
                      if base_uid is not None else -1)
        batch = WriteBuffer(self.store)
        for uid in reversed(keep_uids):
            obj = load_fobject(self.store, uid)
            bases = (prev,) if prev is not None else ()
            new = make_fobject(batch, obj.type, obj.key, obj.data, bases,
                               obj.context, base_depth)
            mapping[uid] = new.uid
            prev = new.uid
            base_depth += 1
        batch.flush()
        self.branches.on_new_version(key, prev, (old_head,))
        self.branches.set_head(key, branch, prev)
        return mapping

    # ----------------------------------------------------------- track
    def track(self, key: bytes, ref: str | bytes,
              dist_rng: tuple[int, int] = (0, 1 << 30)) -> list[FObject]:
        """M15/M16: versions along the primary-parent chain whose distance
        from the given head lies in dist_rng."""
        key = _k(key)
        uid = (self.branches.head(key, ref) if isinstance(ref, str)
               else ref)
        out: list[FObject] = []
        d = 0
        while uid is not None and d < dist_rng[1]:
            obj = load_fobject(self.store, uid)
            if d >= dist_rng[0]:
                out.append(obj)
            uid = obj.bases[0] if obj.bases else None
            d += 1
        return out

    def lca(self, key: bytes, uid1: bytes, uid2: bytes):        # M17
        return mg.lca(self.store, uid1, uid2)

    # ------------------------------------------------------------ diff
    def diff(self, uid1: bytes, uid2: bytes):
        """Type-aware Diff of two versions (same type, any keys, §3.2)."""
        o1 = load_fobject(self.store, uid1)
        o2 = load_fobject(self.store, uid2)
        if o1.type != o2.type:
            raise TypeNotMatch(f"{o1.type_name()} vs {o2.type_name()}")
        if o1.type in (ck.MAP, ck.SET):
            t1 = POSTree.from_root(self.store, o1.type, o1.data, self.params)
            t2 = POSTree.from_root(self.store, o2.type, o2.data, self.params)
            return t1.diff_keys(t2)
        if o1.type in (ck.BLOB, ck.LIST):
            t1 = POSTree.from_root(self.store, o1.type, o1.data, self.params)
            t2 = POSTree.from_root(self.store, o2.type, o2.data, self.params)
            return [op for op in t1.diff_leaf_blocks(t2) if op[0] != "equal"]
        return None if o1.data == o2.data else (o1.data, o2.data)

    # ----------------------------------------------------------- merge
    def merge(self, key: bytes, target, *refs, resolver=None,
              context: bytes = b"") -> bytes:
        """M5 Merge(key, tgt_branch, ref_branch); M6 Merge(key, tgt_branch,
        ref_uid); M7 Merge(key, uid1, uid2, ...) for untagged heads."""
        key = _k(key)
        self._live_fold_key(key)      # merge inputs come from the archive
        if isinstance(target, str):          # M5 / M6
            tgt_uid = self.branches.head(key, target)
            if tgt_uid is None:
                raise NoSuchRef(target)
            ref = refs[0]
            ref_uid = (self.branches.head(key, ref) if isinstance(ref, str)
                       else ref)
            if ref_uid is None:
                raise NoSuchRef(ref)
            merged_uid = self._merge_versions(key, tgt_uid, ref_uid,
                                              resolver, context)
            self.branches.set_head(key, target, merged_uid)
            return merged_uid
        # M7: merge a collection of untagged heads pairwise; the result
        # is itself an untagged (FoC) head until something tags it
        uids = [target, *refs]
        acc = uids[0]
        for u in uids[1:]:
            acc = self._merge_versions(key, acc, u, resolver, context,
                                       foc=True)
        return acc

    def _merge_versions(self, key: bytes, uid1: bytes, uid2: bytes,
                        resolver, context: bytes, *,
                        foc: bool = False) -> bytes:
        o1 = load_fobject(self.store, uid1)
        o2 = load_fobject(self.store, uid2)
        if o1.type != o2.type:
            raise TypeNotMatch(f"{o1.type_name()} vs {o2.type_name()}")
        base_uid = mg.lca(self.store, uid1, uid2)
        base = (load_fobject(self.store, base_uid)
                if base_uid is not None else None)
        t = o1.type
        if t == ck.MAP:
            bm = (FMap.from_tree(POSTree.from_root(self.store, t, base.data,
                                                   self.params))
                  if base is not None and base.type == t else None)
            m1 = FMap.from_tree(POSTree.from_root(self.store, t, o1.data,
                                                  self.params))
            m2 = FMap.from_tree(POSTree.from_root(self.store, t, o2.data,
                                                  self.params))
            merged = mg.merge_map(self.store, bm, m1, m2, resolver)
            data = merged.tree.root_cid
        elif t == ck.SET:
            bs = (FSet.from_tree(POSTree.from_root(self.store, t, base.data,
                                                   self.params))
                  if base is not None and base.type == t else None)
            s1 = FSet.from_tree(POSTree.from_root(self.store, t, o1.data,
                                                  self.params))
            s2 = FSet.from_tree(POSTree.from_root(self.store, t, o2.data,
                                                  self.params))
            merged = mg.merge_set(self.store, bs, s1, s2, resolver)
            data = merged.tree.root_cid
        elif t in (ck.BLOB, ck.LIST):
            bt = (POSTree.from_root(self.store, t, base.data, self.params)
                  if base is not None and base.type == t else None)
            t1 = POSTree.from_root(self.store, t, o1.data, self.params)
            t2 = POSTree.from_root(self.store, t, o2.data, self.params)
            merged_tree = mg.merge_linear(self.store, t, bt, t1, t2,
                                          resolver, self.params)
            data = merged_tree.root_cid
        else:
            data = mg.merge_primitive(t, base.data if base else None,
                                      o1.data, o2.data, resolver)
        depth = max(o1.depth, o2.depth)
        obj = make_fobject(self.store, t, key, data, (uid1, uid2), context,
                           depth)
        self.branches.on_new_version(key, obj.uid, (uid1, uid2), foc=foc)
        return obj.uid

    # ----------------------------------------------------- verification
    def verify_lineage(self, uid: bytes, ancestor: bytes,
                       max_depth: int = 1 << 30) -> bool:
        """Tamper-evidence check (§3.2): is `ancestor` in uid's history?
        Walking hashes re-verifies integrity chunk by chunk when the store
        runs with verify=True."""
        from ..proof.lineage import lineage_path
        return lineage_path(self.store, uid, ancestor,
                            max_depth=max_depth) is not None

    # --------------------------------------------------- proof subsystem
    # Prover-side verbs: each emits a self-contained proof an external
    # verifier checks with repro_torch.proof's stateless verify_* functions,
    # holding only a trusted root cid / head uid / attestation.

    def prove_lineage(self, uid: bytes, ancestor: bytes):
        """Meta-chunk hash chain showing ``ancestor`` in uid's history
        (verify with ``proof.verify_lineage(uid, ancestor, proof)``)."""
        from ..proof.lineage import prove_lineage
        return prove_lineage(self.store, uid, ancestor)

    def prove_version(self, uid: bytes) -> bytes:
        """The raw meta chunk binding ``uid`` to its version record —
        the bridge from a trusted uid to the value's tree root cid
        (verify with ``proof.verify_version(uid, raw)``)."""
        return self.store.get(uid)

    def _tree_of(self, obj: FObject) -> POSTree:
        if obj.type not in CHUNKABLE_TYPES:
            raise TypeNotMatch(obj.type_name())
        return POSTree.from_root(self.store, obj.type, obj.data,
                                 self.params)

    def prove_member(self, key: bytes, branch: str | None = None, *,
                     uid: bytes | None = None, pos: int | None = None,
                     item_key: bytes | None = None):
        """Membership proof for one element of a chunkable value —
        by position (any kind) or by key (Set/Map).  Anchored on the
        value's tree root cid = the ``data`` field of its (provable)
        meta chunk; verify with ``proof.verify_member(root, proof)``.
        Hot paths are served from the per-root proof cache: roots are
        content-addressed, so a cached audit path can never go stale —
        a mutated value has a new root and misses."""
        from ..proof.membership import prove_member
        h = self.get(key, branch, uid=uid)
        if h is None:
            raise NoSuchRef(branch)
        req = ("pos", pos) if pos is not None else ("key", item_key)
        return self._cached_proof(
            h.obj, req,
            lambda: prove_member(self._tree_of(h.obj), pos=pos,
                                 key=item_key))

    def prove_absence(self, key: bytes, branch: str | None = None, *,
                      uid: bytes | None = None,
                      item_key: bytes = b""):
        """Negative membership proof (sorted kinds), cached per root
        like ``prove_member``."""
        from ..proof.membership import prove_absence
        h = self.get(key, branch, uid=uid)
        if h is None:
            raise NoSuchRef(branch)
        return self._cached_proof(
            h.obj, ("absent", item_key),
            lambda: prove_absence(self._tree_of(h.obj), item_key))

    def _cached_proof(self, obj, req, build):
        """Per-root proof-cache plumbing shared by prove_member and
        prove_absence (the root is the value's content-addressed tree
        root, so cached paths can never go stale)."""
        root = bytes(obj.data)
        cached = self.proof_cache.lookup(root, req)
        if cached is not None:
            return cached
        proof = build()
        self.proof_cache.store(root, req, proof)
        return proof

    def _delta(self):
        from ..proof.delta import DeltaAttestor
        if self._delta_attestor is None:
            self._delta_attestor = DeltaAttestor(self.branches)
        return self._delta_attestor

    def attest(self, context: bytes = b"",
               secret: bytes | None = None):
        """Head attestation: a Merkle commitment (optionally HMAC-signed)
        to every branch head this engine serves — the light client's
        trust anchor.  Pair with ``prove_head`` / ``proof.verify_head``.

        Incremental: a persistent Merkle tree over the head entries is
        maintained through branch-table mutation hooks, so an attest
        after k head updates re-hashes O(k log heads) leaves instead of
        rebuilding all of them (proof.delta; first use falls back to one
        full build).  The attestation context carries the GC collector
        epoch, and the committed heads are pinned with the epoch fence:
        proofs against this attestation stay servable until the second
        collection after now begins (gc.EpochFence handshake).

        The pin path is O(k log n) too: the FIRST attest of each fence
        epoch pins the full head baseline; every later attest in the
        same epoch pins only the heads of keys mutated since (the
        baseline pins already cover the unchanged ones at this epoch).
        A collection advancing the fence epoch resets the baseline."""
        from ..proof.delta import pack_epoch
        cluster = getattr(self.store, "cluster", None)
        fence = cluster.gc_fence if cluster is not None else self.gc_fence
        if self._attest_pin_epoch != fence.epoch:
            heads = self.branches.all_heads()     # epoch baseline
            self._attest_pin_epoch = fence.epoch
        else:                                     # delta: O(dirty keys)
            heads = set()
            for k in self._attest_dirty:
                heads |= self.branches.heads_of(k)
        self._attest_dirty.clear()
        epoch = fence.pin(heads)
        self._gc_attest_fence(heads)
        return self._delta().attest(context=pack_epoch(epoch, context),
                                    secret=secret)

    def _gc_attest_fence(self, uids) -> None:
        """Forward freshly attested heads to every in-flight incremental
        collection: a sweep slice must not delete chunks beneath a head
        committed by an attestation issued this epoch."""
        if not self.gc_collectors:
            return
        self.gc_collectors = [c for c in self.gc_collectors if c.active]
        for c in self.gc_collectors:
            c.attest_fence(uids)

    def prove_head(self, key: bytes, branch: str | None = None, *,
                   uid: bytes | None = None):
        """Audit path showing one head is committed by ``attest()``.
        ``branch`` defaults to master (like get); pass ``uid`` for an
        untagged fork-on-conflict head.  Served off the resident delta
        attestation tree: O(log heads) per proof, no re-hashing."""
        from ..proof.attest import UB_TAG, encode_entry
        key = _k(key)
        if branch is None and uid is None:
            branch = DEFAULT_BRANCH
        if branch is None:
            entry = encode_entry(key, UB_TAG, uid)
        else:
            head = self.branches.head(key, branch)
            if head is None:
                raise KeyError(branch)
            entry = encode_entry(key, branch, head)
        return self._delta().prove(entry)

    def audit(self, sample: int = 64, seed: int = 0,
              secret: bytes | None = None):
        """Self-audit through the stateless verifiers (proof.Auditor)."""
        from ..proof.audit import Auditor
        return Auditor(sample=sample, seed=seed).audit_engine(
            self, secret=secret)


def _k(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


def _heads_path(root: str) -> str:
    return os.path.join(root, "heads.json")


def from_state(chunks: Mapping[bytes, bytes], heads: bytes, *,
               params: ChunkParams = DEFAULT_PARAMS,
               store: StorageBackend | None = None,
               verify_get: bool = False) -> ForkBase:
    """An engine over carried-over state: ``chunks`` maps each cid to its
    raw chunk bytes (a store's full contents) and ``heads`` is a
    ``BranchTable.snapshot()`` blob.  The chunks land in one ``put_many``
    with their given cids, so a store built with ``verify=True`` re-hashes
    every one of them under the active cid hash."""
    db = ForkBase(store, params, verify_get=verify_get)
    cids = list(chunks)
    db.store.put_many([bytes(chunks[c]) for c in cids], cids)
    db.branches.restore(bytes(heads))
    return db
