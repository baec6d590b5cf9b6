"""ForkBase connector — the public API (paper Table 1 + guarded Put §4.5.1
+ Diff §3.2), the slice of it that needs no GC, proofs or live tables
(those verbs come with their slices of the port).

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
from typing import Mapping

from . import chunk as ck
from . import merge as mg
from .branch import DEFAULT_BRANCH, BranchTable, GuardFailed, NoSuchRef
from .chunker import ChunkParams, DEFAULT_PARAMS
from .chunkstore import ChunkStore
from .. import obs
from ..storage import StorageBackend, WriteBuffer
from .fobject import FObject, load_fobject, make_fobject
from .postree import POSTree
from .types import (CHUNKABLE_CLASSES, FBlob, FInt, FList, FMap, FSet,
                    FString, FTuple, PRIMITIVE_CLASSES)

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
        tree = POSTree.from_root(self.db.store, kind, self.obj.data,
                                 self.db.params)
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
    §4.1)."""

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
        self._obs_get_tick = 7       # 1-in-8 get timing; first sampled
        # verify-on-get: every Get re-hashes the meta chunk against its
        # uid (per-call ``verify=`` overrides; checks count in StoreStats)
        self.verify_get = verify_get
        self.branches = BranchTable()
        if durable_root is not None:
            head_path = _heads_path(durable_root)
            if os.path.exists(head_path):
                with open(head_path, "rb") as f:
                    self.branches.restore(f.read())

    # ------------------------------------------------------------- put
    def _commit_value(self, value, store=None) -> tuple[int, bytes]:
        """Returns (object type, data field bytes)."""
        if store is None:
            store = self.store
        if hasattr(value, "commit"):          # chunkable handle
            root = value.commit(store)
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

        Reads are histogram-only (``engine_get_us``), timed at a 1-in-8
        sample: a span (or even an unconditional timer) per get would
        tax the O(10µs) hot path the obs-overhead gate protects, so
        only the write verbs carry full span trees."""
        if not obs.REGISTRY.enabled:
            return self._get_inner(key, branch, uid=uid, verify=verify)
        self._obs_get_tick = tick = (self._obs_get_tick + 1) & 7
        if tick:
            return self._get_inner(key, branch, uid=uid, verify=verify)
        t0 = obs.monotonic()
        out = self._get_inner(key, branch, uid=uid, verify=verify)
        obs.REGISTRY.histogram("engine_get_us").observe(obs.monotonic() - t0)
        return out

    def _get_inner(self, key, branch, *, uid, verify):
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
                out[i] = self._get_inner(key, branch,
                                         uid=kw.get("uid"), verify=True)
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
        uid = (self.branches.head(key, ref) if isinstance(ref, str)
               else bytes(ref))
        if uid is None or (not isinstance(ref, str)
                           and not self.store.has(uid)):
            raise NoSuchRef(ref)
        self.branches.fork(key, new_branch, uid)

    def rename(self, key: bytes, old: str, new: str) -> None:   # M13
        self.branches.rename(_k(key), old, new)

    def remove(self, key: bytes, branch: str) -> None:          # M14
        self.branches.remove(_k(key), branch)

    # ------------------------------------------------------- durability
    def sync(self) -> None:
        """Durability point for a durable-root engine: flush the store
        (demote the hot tier, fsync segments, run GC-fed compaction)
        and atomically snapshot the branch heads — after ``sync()``
        returns, reopening the same root resumes with bit-identical
        heads and every chunk reachable from them.  A no-op flush on a
        non-durable engine."""
        self.store.flush()
        if self._durable_root is not None:
            from ..storage.durable import write_durably
            write_durably(_heads_path(self._durable_root),
                          self.branches.snapshot())

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
