"""Checkpoints and GC of the port against the JAX package, exactly.

The state is the reference's ``init_train_state(smoke(tinyllama-1.1b),
PRNGKey(0), shards=4)`` as numpy (bf16 leaves through ``ml_dtypes``),
handed to the port as torch tensors (bf16 through an int16 view).

* Both packages save the same states, with sha256 cids and with fphash
  cids (the reference on its Pallas chunker, in interpret mode here): the
  checkpoint uids and the manifest bytes must be equal.
* A durable root written by either package restores in the other, bit
  for bit.
* Leaf names and order follow JAX's flattening over every container kind
  (dict, defaultdict, OrderedDict, list, tuple, namedtuple, None), and a
  tree of them saved by either package restores in the other with its
  container types.
* The same GC workload gives equal ``GCReport``s: stop-the-world, and
  incremental at budgets 1, 7 and 64, with and without a checkpoint saved
  in the middle of the mark.
* ``prune`` with the same policy keeps the same uids and reports the same
  collection.
* A save folds the engine's dirty live tables first, as the reference's
  does: the same folded head, under the save's ``ckpt_step`` context.

The GC and prune workloads run on the states' ``params`` and
``opt/step`` (the f32 optimizer moments add bytes, not cases), are built
once per package and copied into a fresh store for each collection.

The hash and chunker hooks are process-global, so every test that flips
one restores it in ``finally``.
"""
import collections
import contextlib
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointStore as RefCheckpointStore
from repro.ckpt.store import _leaf_paths as ref_leaf_paths
from repro.configs import ARCHS, smoke
from repro.core import ForkBase as RefForkBase
from repro.core import hashing as ref_hashing
from repro.gc import GCPhase as RefGCPhase
from repro.kernels.ops import use_pallas_chunker
from repro.storage import MemoryBackend as RefMemoryBackend
from repro.train import init_train_state
from repro_torch.ckpt import CheckpointStore
from repro_torch.ckpt.store import _leaf_paths, _unflatten
from repro_torch.core import ForkBase, hashing
from repro_torch.gc import GCPhase
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend
from torch_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@contextlib.contextmanager
def cid_hash(name):
    """fphash cids in both packages (the reference also on its Pallas
    chunker), or the default sha256."""
    if name == "sha256":
        yield
        return
    ref_hashing.use_fphash()
    use_pallas_chunker(True)
    hashing.use_fphash()
    try:
        yield
    finally:
        ref_hashing.use_sha256()
        use_pallas_chunker(False)
        hashing.use_sha256()


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")          # a C-ordered copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def leaf_bytes(x) -> tuple[str, tuple, bytes]:
    """dtype name, shape and raw bytes of a numpy/JAX array or a tensor."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        return (name, tuple(x.shape),
                x.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.fixture(scope="module")
def states():
    """Four numpy states: the initial one, two training-like edits of it
    (the last layer's slice of the stacked tensors, the step counter) and
    a fork's edit of the first of them."""
    cfg = smoke(ARCHS["tinyllama-1.1b"])
    s0 = jax.tree.map(np.asarray,
                      init_train_state(cfg, jax.random.PRNGKey(0), shards=4))
    rng = np.random.default_rng(5)

    def edit(s, step):
        def one(a):
            a = a.copy()
            if a.ndim == 0:
                return np.asarray(step, dtype=a.dtype)
            if a.ndim == 3:                       # stacked layers: the last
                noise = rng.standard_normal(a[-1].shape) * 0.01
                a[-1] = (a[-1].astype(np.float32) + noise).astype(a.dtype)
            return a
        return tree_map(one, s)

    s1 = edit(s0, 1)
    s2 = edit(s1, 2)
    s3 = edit(s1, 3)
    return [s0, s1, s2, s3]


def torch_state(s):
    return tree_map(to_torch, s)


@pytest.fixture(scope="module")
def small_states(states):
    return [{"params": s["params"], "opt": {"step": s["opt"]["step"]}}
            for s in states]


def clone(cs, db_cls, store_cls, cs_cls):
    """A checkpoint store over a fresh engine holding ``cs``'s chunks (put
    in cid order) and branch table."""
    cids = sorted(cs.db.store.iter_cids())
    db = db_cls(store_cls())
    db.store.put_many(cs.db.store.get_many(cids), cids)
    db.branches.restore(cs.db.branches.snapshot())
    return cs_cls(db)


def clone_ref(cs):
    return clone(cs, RefForkBase, RefMemoryBackend, RefCheckpointStore)


def clone_port(cs):
    return clone(cs, ForkBase, MemoryBackend, CheckpointStore)


def assert_restored(got, want):
    flat_g = jax.tree_util.tree_flatten_with_path(got)
    flat_w = jax.tree_util.tree_flatten_with_path(want)
    assert [p for p, _ in flat_g[0]] == [p for p, _ in flat_w[0]]
    for (path, g), (_, w) in zip(flat_g[0], flat_w[0]):
        assert leaf_bytes(g) == leaf_bytes(w), path


def run_ref(db, states):
    """The shared workload in the reference: two saves on ``run``, a fork
    of step 1 with its own save, returning the uids."""
    cs = RefCheckpointStore(db)
    u0 = cs.save(states[0], "run", step=0)
    u1 = cs.save(states[1], "run", step=1)
    u2 = cs.save(states[2], "run", step=2)
    cs.fork(u1, "exp")
    u3 = cs.save(states[3], "exp", step=3)
    return cs, [u0, u1, u2, u3]


def run_port(db, states):
    cs = CheckpointStore(db)
    ts = [torch_state(s) for s in states]
    u0 = cs.save(ts[0], "run", step=0)
    u1 = cs.save(ts[1], "run", step=1)
    u2 = cs.save(ts[2], "run", step=2)
    cs.fork(u1, "exp")
    u3 = cs.save(ts[3], "exp", step=3)
    return cs, [u0, u1, u2, u3]


def manifest_bytes(db, uid) -> tuple[bytes, list]:
    """The manifest's root chunk and its entries."""
    m = db.get("ckpt", uid=uid).map()
    return db.store.get(m.tree.root_cid), list(m.items())


# ------------------------------------------------------------ save parity

@pytest.mark.parametrize("cid", ["sha256", "fphash"])
def test_save_folds_dirty_live_tables_first(cid):
    """A save is an epoch boundary: a live table written since its last
    fold is folded, under the save's ``ckpt_step`` context, before the
    checkpoint lands.  The folded head and the checkpoint uid are the
    reference's."""
    leaf = np.arange(48, dtype=np.float32).reshape(6, 8)
    got = {}
    with cid_hash(cid):
        for pkg, db, cs_cls, state in (
                ("reference", RefForkBase(RefMemoryBackend()),
                 RefCheckpointStore, {"w": leaf}),
                ("port", ForkBase(MemoryBackend()), CheckpointStore,
                 {"w": to_torch(leaf)})):
            table = db.live(b"accounts")
            for i in range(40):
                table.put(f"k{i:03d}".encode(), f"v{i}".encode() * 4)
            uid = cs_cls(db).save(state, "run", step=7)
            head = db.get(b"accounts")
            got[pkg] = (table.dirty_count, head.uid, head.obj.context,
                        bytes(head.map().get(b"k039")), uid)
    dirty, _, context, value, _ = got["port"]
    assert dirty == 0
    assert context == json.dumps({"ckpt_step": 7}).encode()
    assert value == b"v39" * 4
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("cid", ["sha256", "fphash"])
def test_checkpoint_uids_and_manifests_are_the_reference_s(states, cid):
    """The whole train state, then its edit (dedup against the first) and
    a fork of the first."""
    with cid_hash(cid):
        ref_cs = RefCheckpointStore(RefForkBase(RefMemoryBackend()))
        cs = CheckpointStore(ForkBase(MemoryBackend()))
        ref_uids = [ref_cs.save(states[i], "run", step=i) for i in (0, 1)]
        uids = [cs.save(torch_state(states[i]), "run", step=i)
                for i in (0, 1)]
        ref_cs.fork(ref_uids[0], "exp")
        cs.fork(uids[0], "exp")
    assert uids == ref_uids
    for u in uids:
        assert manifest_bytes(cs.db, u) == manifest_bytes(ref_cs.db, u)
    assert cs.db.store.get_many(uids) == ref_cs.db.store.get_many(uids)
    assert (sorted(cs.db.store.iter_cids())
            == sorted(ref_cs.db.store.iter_cids()))
    assert cs.db.branches.snapshot() == ref_cs.db.branches.snapshot()


# ------------------------------------------------- leaf names and order

# optax's Adam state is a namedtuple of this shape
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          ["count", "mu", "nu"])


def mixed_tree(rng) -> dict:
    """Every container kind JAX flattens, with numpy leaves of several
    dtypes and shapes (a 0-d int32 among them; no 64-bit dtype, which
    the reference's restore narrows with JAX's x64 mode off)."""
    def leaf(shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    return {
        "opt": (ScaleByAdamState(count=np.asarray(3, dtype=np.int32),
                                 mu={"w": leaf((2, 3)), "b": leaf(3)},
                                 nu={"w": leaf((2, 3)), "b": leaf(3)}),
                None),
        "od": collections.OrderedDict([("z", leaf(4)),
                                       ("a", leaf((1, 2), np.float16))]),
        "dd": collections.defaultdict(list, {"q": leaf(2), "b": leaf(5)}),
        "l": [None, leaf(1, jax.numpy.bfloat16), (leaf((2, 2)), [leaf(7)])],
        "none": None,
    }


def test_leaf_paths_are_the_reference_s():
    tree = mixed_tree(np.random.default_rng(11))
    ref, _ = ref_leaf_paths(tree)
    assert ([(n, id(x)) for n, x in _leaf_paths(tree)]
            == [(n, id(x)) for n, x in ref])
    assert "opt/0/.mu/w" in [n for n, _ in ref]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mixed_tree_restores_across_packages(writer):
    """The mixed tree saved by one package (the same uid in both) restores
    in the other bit for bit, with its container types."""
    tree = mixed_tree(np.random.default_rng(12))
    like = _unflatten(tree, iter(to_torch(x) for _, x in _leaf_paths(tree)))
    ref_cs = RefCheckpointStore(RefForkBase(RefMemoryBackend()))
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    assert (cs.save(like, "run", step=0)
            == ref_cs.save(tree, "run", step=0))
    if writer == "reference":
        got = clone_port(ref_cs).restore(like, "run")
    else:
        got = clone_ref(cs).restore(tree, "run")
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(tree))
    assert_restored(got, tree)


# --------------------------------------------------- cross-package restore

def test_reference_durable_root_restores_in_the_port(states, tmp_path):
    root = str(tmp_path / "ref")
    ref_cs = RefCheckpointStore(durable_root=root)
    ref_cs.save(states[0], "run", step=0)
    ref_cs.save(states[1], "run", step=1)
    ref_cs.sync()
    ref_cs.db.store.close()
    cs = CheckpointStore(durable_root=root)
    like = torch_state(states[0])
    assert_restored(cs.restore(like, "run"), states[1])
    old = cs.history("run")[1][0]
    assert_restored(cs.restore(like, uid=old), states[0])
    cs.db.store.close()


def test_port_durable_root_restores_in_the_reference(states, tmp_path):
    root = str(tmp_path / "port")
    cs = CheckpointStore(durable_root=root)
    cs.save(torch_state(states[0]), "run", step=0)
    cs.save(torch_state(states[1]), "run", step=1)
    cs.sync()
    cs.db.store.close()
    ref_cs = RefCheckpointStore(durable_root=root)
    assert_restored(ref_cs.restore(states[0], "run"), states[1])
    old = ref_cs.history("run")[1][0]
    assert_restored(ref_cs.restore(states[0], uid=old), states[0])
    ref_cs.db.store.close()


# -------------------------------------------------------------- GC parity

def report_of(r) -> dict:
    return dataclasses.asdict(r)


def collect(db, phase_cls, mode, budget, save_mid):
    """One collection of ``mode`` ("stw" or "incremental"); ``save_mid``
    saves a checkpoint between the first and second slice."""
    if mode == "stw":
        return db.gc()
    col = db.incremental_gc()
    col.step(budget)
    if save_mid is not None:
        save_mid()
    while col.step(budget) is not phase_cls.DONE:
        pass
    return col.report


@pytest.fixture(scope="module")
def gc_workload(small_states):
    """Both packages after the shared workload, with the fork's branch
    removed: its own checkpoint is garbage."""
    ref_cs, _ = run_ref(RefForkBase(RefMemoryBackend()), small_states)
    cs, _ = run_port(ForkBase(MemoryBackend()), small_states)
    for c in (ref_cs, cs):
        c.db.remove("ckpt", "exp")
    return ref_cs, cs


@pytest.mark.parametrize("mode,budget,save_mid", [
    ("stw", 0, False),
    ("incremental", 1, False),
    ("incremental", 7, False),
    ("incremental", 64, False),
    ("incremental", 7, True),
], ids=["stw", "inc-1", "inc-7", "inc-64", "inc-7-save-mid-mark"])
def test_gc_reports_are_the_reference_s(small_states, gc_workload, mode,
                                        budget, save_mid):
    ref_cs, cs = clone_ref(gc_workload[0]), clone_port(gc_workload[1])
    ref_mid = (lambda: ref_cs.save(small_states[3], "run", step=3)) \
        if save_mid else None
    mid = (lambda: cs.save(torch_state(small_states[3]), "run", step=3)) \
        if save_mid else None
    ref = collect(ref_cs.db, RefGCPhase, mode, budget, ref_mid)
    got = collect(cs.db, GCPhase, mode, budget, mid)
    assert got.swept_chunks > 0
    assert report_of(got) == report_of(ref)
    if save_mid:
        assert got.barriered > 0
    assert (sorted(cs.db.store.iter_cids())
            == sorted(ref_cs.db.store.iter_cids()))
    assert_restored(cs.restore(torch_state(small_states[0]), "run"),
                    small_states[3] if save_mid else small_states[2])


@pytest.fixture(scope="module")
def prune_workload(small_states):
    """Five checkpoints on one branch in both packages."""
    ref_cs = RefCheckpointStore(RefForkBase(RefMemoryBackend()))
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    for step in range(5):
        s = small_states[step % 4]
        ref_cs.save(s, "run", step=step)
        cs.save(torch_state(s), "run", step=step)
    return ref_cs, cs


@pytest.mark.parametrize("keep_last,keep_every,incremental", [
    (1, None, False), (2, 2, False), (1, 2, True)])
def test_prune_keeps_the_reference_s_uids(prune_workload, keep_last,
                                          keep_every, incremental):
    ref_cs, cs = clone_ref(prune_workload[0]), clone_port(prune_workload[1])
    ref_kept, ref_rep = ref_cs.prune("run", keep_last=keep_last,
                                     keep_every=keep_every,
                                     incremental=incremental, budget=16)
    kept, rep = cs.prune("run", keep_last=keep_last, keep_every=keep_every,
                         incremental=incremental, budget=16)
    assert kept == ref_kept
    assert report_of(rep) == report_of(ref_rep)
    assert cs.history("run") == ref_cs.history("run")
