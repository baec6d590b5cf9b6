"""ForkBase-backed checkpointing — the storage engine as the training
framework's state substrate.

Layout per checkpoint:
  * every tensor leaf -> an FBlob (POS-Tree over its raw bytes): chunk-level
    dedup across steps (optimizer moments / embeddings barely change
    between nearby steps) and across experiment forks;
  * one FMap manifest per checkpoint: tree path -> JSON{root cid, dtype,
    shape}; committed as a single Put on the run's branch, so the manifest
    uid is the tamper-evident version of the WHOLE training state and its
    ``bases`` chain is the training lineage;
  * fork-on-demand  = hyperparameter fork / warm restart from any step;
  * fork-on-conflict = two pods racing to commit the same step leave two
    untagged heads; the controller resolves (runtime/controller.py).

Leaves are ``torch.Tensor``s on any device (anything else goes through
``torch.as_tensor``).  The format is the JAX package's, byte for byte:
leaf names and their order follow JAX's pytree flattening (dict keys
sorted, lists and tuples by index, namedtuple fields as ``.field``,
``None`` an empty subtree, names joined by ``/``), dtypes are stored
under numpy's names (``"bfloat16"``, ``"float32"``), and the manifest
and context JSON are the same strings — so a checkpoint written by
either package restores in the other.

Restore rebuilds tensors from the manifest and places each on its template
leaf's device, on ``mesh`` when that is a ``torch.device``, or by ``specs``
on a ``repro_torch.mesh.Mesh``: the checkpoint is placement-agnostic.  On
a mesh of ranks (a process per device), a save gathers one leaf at a time
whole on rank 0 alone (``mesh.gather_whole``), which puts it and frees it,
so the checkpoint's bytes and uid are those of a one-device save of the
same values; a restore reads one leaf at a time on rank 0 and sends each
rank its block (``Mesh.place_from_root``).  No rank but rank 0 holds a
leaf whole, and rank 0 one or two at a time.  Only rank 0's store is read
or written there.  Specs
that name an axis (for a plain device) or an axis of size > 1 (for a
one-device mesh) raise ``ConfigError``.
"""
from __future__ import annotations

import json
import warnings
from collections import OrderedDict, defaultdict

import torch

from ..core import ForkBase, FBlob, FMap, NoSuchRef, POSTree, load_fobject
from ..core import chunk as ck
from ..errors import CheckpointMissing, ConfigError, TensorMissing
from ..mesh import Mesh, gather_whole, spec_axes
from ..storage import WriteBuffer

# numpy's dtype names (what the manifest stores) <-> torch dtypes; the
# wide unsigned types exist only in newer torch builds
_DTYPES: dict[str, torch.dtype] = {
    name: getattr(torch, name) for name in (
        "bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
        "uint32", "uint64", "float16", "bfloat16", "float32", "float64",
        "complex64", "complex128")
    if hasattr(torch, name)}
_DTYPE_NAMES: dict[torch.dtype, str] = {v: k for k, v in _DTYPES.items()}


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _children(node):
    """(path entry, child) pairs of a container node in JAX's order, or
    None for a leaf.  As in JAX, only these exact types are containers
    (a subclass of dict, list or tuple, namedtuples aside, is a leaf);
    a namedtuple's fields are named ``.field``, as JAX's ``GetAttrKey``
    prints."""
    if node is None:
        return []
    kind = type(node)
    if kind is OrderedDict:
        return list(node.items())
    if kind is dict or kind is defaultdict:
        return [(k, node[k]) for k in sorted(node)]
    if kind is list or kind is tuple:
        return list(enumerate(node))
    if _is_namedtuple(node):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    return None


def _leaf_paths(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(name, leaf) of every leaf of ``tree`` in JAX's flattening order,
    named as ``jax.tree_util.tree_flatten_with_path`` paths joined by
    ``/``."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for entry, child in kids:
        out += _leaf_paths(child, prefix + (entry,))
    return out


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in ``_leaf_paths`` order, by the
    items of iterator ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if tree is None:
        return None
    values = [(k, _unflatten(v, leaves)) for k, v in kids]
    kind = type(tree)
    if kind is defaultdict:
        return defaultdict(tree.default_factory, values)
    if kind is dict or kind is OrderedDict:
        return kind(values)
    if kind is list or kind is tuple:
        return kind(v for _, v in values)
    return kind(*(v for _, v in values))              # a namedtuple


def _dtype_name(t: torch.Tensor) -> str:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise ConfigError(f"checkpoint leaf dtype {t.dtype} has no "
                          f"stored name")
    return name


def _leaf_record(leaf) -> tuple[bytes, str, list[int]]:
    """The bytes, dtype name and shape of one leaf.  A device tensor is
    copied to the host here (the put path copies its bytes back to the
    device for the chunker)."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    t = t.detach()
    name = _dtype_name(t)
    # a 0-d tensor cannot be viewed as bytes: flatten it first
    raw = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    return raw, name, list(t.shape)


def _has_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor) for _, leaf in _leaf_paths(tree))


def _wholes(paths):
    """``(name, leaf)`` of ``paths`` one at a time, each ``DTensor`` whole
    on its mesh's origin and None elsewhere (``gather_whole``, collectives
    that every rank joins in the same order), any other leaf as it is."""
    from torch.distributed.tensor import DTensor
    for name, leaf in paths:
        yield name, (gather_whole(leaf) if isinstance(leaf, DTensor)
                     else leaf)


def _spec_leaves(like, specs) -> list:
    """The spec of each leaf of ``like``, in ``_leaf_paths`` order: the
    entry of ``specs`` at the leaf's path (a tuple of mesh axis names; a
    missing or None subtree replicates)."""
    out = []

    def walk(node, sp):
        kids = _children(node)
        if kids is None:
            out.append(sp)
            return
        for k, child in kids:
            sub = None
            if isinstance(sp, dict):
                sub = sp.get(k)
            elif isinstance(sp, (list, tuple)) and isinstance(k, int) \
                    and not _is_spec(sp):
                sub = sp[k]
            elif sp is not None and not _is_spec(sp):
                raise ConfigError(f"specs {sp!r} do not follow the tree")
            walk(child, sub)
    walk(like, specs)
    return out


def _is_spec(x) -> bool:
    """A spec: a tuple whose entries are None, axis names or tuples of
    axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _tensor_of(data: bytes, meta: dict, device) -> torch.Tensor:
    dtype = _DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ConfigError(f"checkpoint dtype {meta['dtype']!r} is not "
                          f"supported")
    if not data:
        return torch.empty(0, dtype=dtype).reshape(meta["shape"]).to(device)
    with warnings.catch_warnings():
        # the tensor only views the read-only bytes until the copy below
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        t = torch.frombuffer(data, dtype=dtype).reshape(meta["shape"])
    device = torch.device(device)
    return t.clone() if device.type == "cpu" else t.to(device)


def manifest_refs(raw: bytes) -> list[bytes]:
    """GC link extractor for checkpoint manifests: a manifest is an FMap
    whose values are JSON ``{"cid": <hex tensor-tree root>, ...}`` — an
    application-level reference the chunk format can't expose.  This hook
    (gc.mark ``ref_hooks``) surfaces those roots so the mark phase walks
    the tensor trees of every live manifest.  Non-JSON / cid-less values
    are skipped; gc validates extracted refs before following them."""
    if ck.chunk_type(raw) != ck.MAP:
        return []
    refs = []
    for _, v in ck.unpack_kv_stream(ck.chunk_payload(raw)):
        try:
            meta = json.loads(v)
            cid = bytes.fromhex(meta["cid"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            continue
        if len(cid) == 32:
            refs.append(cid)
    return refs


class CheckpointStore:
    def __init__(self, db: ForkBase | None = None, key: str = "ckpt", *,
                 durable_root: str | None = None):
        """``durable_root`` (without an explicit ``db``) opens the engine
        over the durable tiered store (storage.durable): checkpoints
        survive process death, and ``sync()`` is the barrier that makes
        a just-saved step restorable after a crash."""
        if db is None:
            db = (ForkBase(durable_root=durable_root)
                  if durable_root is not None else ForkBase())
        self.db = db
        self.key = key
        if manifest_refs not in self.db.gc_hooks:
            self.db.gc_hooks.append(manifest_refs)

    def sync(self) -> None:
        """Durability barrier: flush chunks + snapshot branch heads (see
        ``ForkBase.sync``).  A restore after a crash sees exactly the
        checkpoints saved before the last ``sync()``."""
        self.db.sync()

    # ------------------------------------------------------------- save
    def _commit_leaves(self, leaves, manifest: FMap) -> None:
        """Every leaf's bytes (``leaves``: ``(name, leaf)`` pairs, taken one
        at a time) as an FBlob, all in ONE put_many, and its manifest
        entry."""
        batch = WriteBuffer(self.db.store)
        for name, leaf in leaves:
            raw, dtype, shape = _leaf_record(leaf)
            del leaf               # the next leaf comes before the loop
            root = FBlob(raw).commit(batch)
            meta = {"cid": root.hex(), "dtype": dtype, "shape": shape}
            manifest.set(name.encode(), json.dumps(meta).encode())
        batch.flush()

    def save(self, state, branch: str, *, step: int,
             extra: dict | None = None) -> bytes:
        """Commit ``state`` (a pytree of tensors) as one version on
        ``branch``.  Returns the checkpoint uid.

        A checkpoint save is an epoch boundary for the engine's live
        tables (repro_torch.live): any flat-path deltas are folded into
        their POS-Trees first, so the checkpoint never lands on a store
        whose durable state lags the served state.

        A state of ``DTensor``s (a mesh of ranks) is gathered one leaf at
        a time on rank 0 alone, which commits it; every rank returns its
        uid (its broadcast is the barrier: no rank returns before the
        checkpoint is in)."""
        if _has_dtensor(state):
            return self._save_ranks(state, branch, step, extra)
        return self._save_leaves(_leaf_paths(state), branch, step, extra)

    def _save_leaves(self, leaves, branch: str, step: int,
                     extra: dict | None) -> bytes:
        if getattr(self.db, "_live", None):
            self.db.commit_epoch(context=json.dumps(
                {"ckpt_step": step}).encode())
        head = self.db.get(self.key, branch)
        manifest = (head.map() if head is not None else FMap())
        self._commit_leaves(leaves, manifest)
        ctx = json.dumps({"step": step, **(extra or {})}).encode()
        return self.db.put(self.key, manifest, branch, context=ctx)

    def _save_ranks(self, state, branch: str, step: int,
                    extra: dict | None) -> bytes:
        """``save`` on a mesh of ranks: every rank joins each leaf's gather
        in turn and rank 0 commits the leaves as they come."""
        import torch.distributed as dist
        paths = _leaf_paths(state)
        for _, leaf in paths:      # every rank, before any collective
            if isinstance(leaf, torch.Tensor):
                _dtype_name(leaf)
        leaves = _wholes(paths)
        uid = [None]
        if dist.get_rank() == 0:
            uid[0] = self._save_leaves(leaves, branch, step, extra)
        else:
            for _ in leaves:
                pass
        dist.broadcast_object_list(uid, src=0)
        return uid[0]

    def save_on_base(self, state, base_uid: bytes, *, step: int,
                     extra: dict | None = None) -> bytes:
        """Fork-on-conflict commit path: Put against an explicit base
        version (two pods racing on the same step produce two untagged
        heads, paper §3.3.2)."""
        manifest = self.db.get(self.key, uid=base_uid).map()
        self._commit_leaves(_leaf_paths(state), manifest)
        ctx = json.dumps({"step": step, **(extra or {})}).encode()
        return self.db.put(self.key, manifest, base_uid=base_uid,
                           context=ctx)

    # ---------------------------------------------------------- restore
    def restore(self, like, branch: str | None = None,
                uid: bytes | None = None, mesh=None, specs=None):
        """Rebuild the pytree of ``like`` (its structure names the leaves;
        dtypes and shapes come from the manifest).  Each tensor lands on
        its template leaf's device (the CPU for a leaf that is not a
        tensor), on ``mesh`` when that is a ``torch.device``, or placed by
        ``specs`` (a tree of specs shaped as ``like``) on a
        ``repro_torch.mesh.Mesh`` — the restart placement need not match
        the writer's.  On a mesh of ranks rank 0 reads and every rank gets
        its shards.  As in the reference, ``specs`` are ignored without a
        ``mesh``.  With a device they must replicate every leaf (no entry
        names a mesh axis), else ConfigError."""
        if isinstance(mesh, Mesh):
            if mesh.spmd:
                return self._restore_ranks(like, branch, uid, mesh, specs)
            if mesh.devices is None:
                raise ConfigError(f"restore onto {mesh}: an abstract mesh "
                                  f"binds no device")
            leaf_specs = _spec_leaves(like, specs)
            return _unflatten(like, iter(
                mesh.place(t, sp) for t, sp in
                zip(self._read_leaves(like, branch, uid, mesh.device),
                    leaf_specs)))
        if mesh is not None and not isinstance(mesh, torch.device):
            raise ConfigError(f"restore onto {type(mesh).__name__}: only a "
                              f"torch.device or a Mesh is supported")
        if mesh is not None and specs is not None:
            named = spec_axes(specs)
            if named:
                raise ConfigError(f"restore onto {mesh} with specs that "
                                  f"shard over mesh axes {sorted(set(named))}"
                                  f": one device has no mesh")
        return _unflatten(like, iter(self._read_leaves(like, branch, uid,
                                                       mesh)))

    def _read_leaves(self, like, branch, uid, device) -> list:
        """The tensors of ``like``'s leaves, in ``_leaf_paths`` order, on
        ``device`` (None: each template leaf's device, or the CPU)."""
        out = []
        for (_, leaf), meta in zip(_leaf_paths(like),
                                   self._leaf_metas(like, branch, uid)):
            dev = (device if device is not None
                   else leaf.device if isinstance(leaf, torch.Tensor)
                   else torch.device("cpu"))
            out.append(self._read_leaf(meta, dev))
        return out

    def _leaf_metas(self, like, branch, uid) -> list[dict]:
        """The manifest entry of each of ``like``'s leaves, in
        ``_leaf_paths`` order; CheckpointMissing, TensorMissing, or
        ConfigError for a dtype this torch lacks."""
        handle = self.db.get(self.key, branch, uid=uid)
        if handle is None:
            raise CheckpointMissing(f"{self.key!r}@{branch or uid!r}")
        manifest = handle.map()
        out = []
        for name, _ in _leaf_paths(like):
            raw = manifest.get(name.encode())
            if raw is None:
                raise TensorMissing(name)
            meta = json.loads(raw)
            if meta["dtype"] not in _DTYPES:
                raise ConfigError(f"checkpoint dtype {meta['dtype']!r} is "
                                  f"not supported")
            out.append(meta)
        return out

    def _read_leaf(self, meta: dict, device) -> torch.Tensor:
        tree = POSTree.from_root(self.db.store, ck.BLOB,
                                 bytes.fromhex(meta["cid"]))
        return _tensor_of(tree.read_bytes(0, tree.total_count), meta, device)

    def _restore_ranks(self, like, branch, uid, mesh, specs):
        """``restore`` on a mesh of ranks: rank 0 reads the manifest, and
        every rank learns each leaf's shape and dtype from it (or the
        error rank 0 met, which every rank then raises); then rank 0 reads
        one leaf at a time and sends each rank its block."""
        import torch.distributed as dist
        leaf_specs = _spec_leaves(like, specs)
        src = mesh.device_mesh.get_rank() == 0
        metas, head = [], [None]
        if src:
            try:
                metas = self._leaf_metas(like, branch, uid)
                head[0] = [(m["shape"], _DTYPES[m["dtype"]]) for m in metas]
            except (CheckpointMissing, TensorMissing, ConfigError) as e:
                head[0] = e
        dist.broadcast_object_list(head, src=0)
        if isinstance(head[0], Exception):
            raise head[0]
        out = []
        for i, ((shape, dtype), sp) in enumerate(zip(head[0], leaf_specs)):
            # no reference kept here: the leaf is freed once it is cut
            out.append(mesh.place_from_root(
                self._read_leaf(metas[i], mesh.device) if src else None,
                shape, dtype, sp))
        return _unflatten(like, iter(out))

    # ------------------------------------------------------------ meta
    def step_of(self, uid: bytes) -> int:
        obj = load_fobject(self.db.store, uid)
        return json.loads(obj.context or b"{}").get("step", -1)

    def history(self, branch: str, limit: int = 100):
        return [(o.uid, json.loads(o.context or b"{}"))
                for o in self.db.track(self.key, branch, (0, limit))]

    def fork(self, ref: str | bytes, new_branch: str) -> None:
        """Experiment fork (warm restart from any historical version)."""
        self.db.fork(self.key, ref, new_branch)

    # -------------------------------------------------------- retention
    def prune(self, branch: str, *, keep_last: int = 1,
              keep_every: int | None = None, collect: bool = True,
              incremental: bool = False, budget: int = 256):
        """Retention policy over a training run: keep the newest
        ``keep_last`` checkpoints plus every ``keep_every``-th step,
        rewrite the branch's manifest chain to exactly those versions
        (``ForkBase.truncate_history``) and — unless ``collect=False`` —
        run GC so the retired manifests and any tensor chunks only they
        referenced are reclaimed.  Tensor chunks shared with surviving
        checkpoints (the dedup win) stay, of course.

        The kept versions get new uids (their ``bases`` are relinked);
        returns (kept uids newest-first, GCReport | None).  History
        shared with another branch is never rewritten: the walk stops at
        the first version some other head can reach and the rewritten
        chain is *anchored* on it, so forks keep their full lineage and
        ``lca``/``merge`` across related runs still find the common
        ancestor.  Pinned uids (``hold``) survive regardless of the
        policy.

        ``incremental=True`` drives the collection through
        ``gc.IncrementalCollector`` in ``budget``-bounded slices, so a
        retention pass on a live training run never stalls committers
        for a full-DAG mark (checkpoint manifests are traced through
        the ``manifest_refs`` hook either way)."""
        head = self.db.get(self.key, branch)
        if head is None:
            raise NoSuchRef(branch)
        chain = self.db.track(self.key, branch)   # newest first
        head_uid = head.uid
        tagged = self.db.list_tagged_branches(self.key)
        # heads of every OTHER branch (by name: a twin tag sharing our
        # head uid still protects it) + untagged racing heads
        other_heads = {u for b, u in tagged.items() if b != branch}
        other_heads |= (set(self.db.list_untagged_branches(self.key))
                        - {head_uid})
        external = self._reachable_versions(other_heads)
        keep: list[bytes] = []
        anchor: bytes | None = None
        for i, obj in enumerate(chain):
            if obj.uid in external:               # shared lineage: stop
                anchor = obj.uid
                break
            step = json.loads(obj.context or b"{}").get("step", -1)
            if i < keep_last or (keep_every is not None and step >= 0
                                 and step % keep_every == 0):
                keep.append(obj.uid)
        if keep:
            mapping = self.db.truncate_history(self.key, branch, keep,
                                               base_uid=anchor)
            kept = [mapping[u] for u in keep]
        else:
            kept = []                             # head itself is shared
        return kept, (self.db.gc(incremental=incremental, budget=budget)
                      if collect else None)

    def _reachable_versions(self, heads) -> set[bytes]:
        """Meta-level reachability (bases chains only) from ``heads`` —
        batched like gc.mark: one get_many per DAG level."""
        from ..core.fobject import FObject
        seen: set[bytes] = set(heads)
        frontier = list(seen)
        while frontier:
            nxt: list[bytes] = []
            for raw in self.db.store.get_many(frontier):
                for b in FObject.deserialize(raw, b"").bases:
                    if b not in seen:
                        seen.add(b)
                        nxt.append(b)
            frontier = nxt
        return seen

    def hold(self, *uids: bytes):
        """Retention hold (context manager): pin checkpoint versions an
        external consumer still reads, shielding them from prune+gc."""
        return self.db.pins.hold(*uids)

    def verify(self, uid: bytes, ancestor: bytes) -> bool:
        """Tamper-evident lineage check: does ``uid`` derive from
        ``ancestor``?  (model provenance; ``ForkBase.verify_lineage``
        walks a lineage proof of the bases chain)."""
        return self.db.verify_lineage(uid, ancestor)

    def racing_heads(self):
        return self.db.list_untagged_branches(self.key)

    def resolve_race(self, *uids, prefer: str = "step") -> bytes:
        """Merge racing pod commits: keep the head with the greatest
        data progress (context step), paper-style choose-one resolution
        at the version level."""
        from ..core.merge import choose_one
        best = max(uids, key=self.step_of)
        acc = best
        for u in (u for u in uids if u != best):
            acc = self.db.merge(self.key, acc, u, resolver=choose_one(0))
        return acc

    @property
    def dedup_stats(self):
        return self.db.store.stats


def save_tree(state, db: ForkBase, branch: str = "master", step: int = 0):
    return CheckpointStore(db).save(state, branch, step=step)


def restore_tree(like, db: ForkBase, branch: str = "master"):
    return CheckpointStore(db).restore(like, branch)
