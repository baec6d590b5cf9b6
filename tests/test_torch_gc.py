"""GC of the port (repro_torch.gc), on the CPU: root-set extraction,
batched mark, sweep, pins, checkpoint retention (prune and hold), and the
core safety property — GC never collects a chunk reachable from any
surviving head, under randomized put/fork/merge/remove/gc workloads.

The JAX package's ``tests/test_gc.py``, its three cluster tests
included.  Checkpoint states are
dicts of float32 tensors made from the same numpy draws."""

import numpy as np
import pytest
import torch

from repro_torch.core import (BranchExists, Cluster, FBlob, ForkBase,
                              FString, NoSuchRef)
from repro_torch.gc import PinSet, mark
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@pytest.fixture
def db():
    return ForkBase(MemoryBackend())


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# ------------------------------------------------------------------ mark

def test_mark_walks_history_and_trees(db, rng):
    """Everything reachable from one head — bases chain + every POS-Tree
    level of every version — is live."""
    datas = [rng.bytes(50_000) for _ in range(3)]
    for d in datas:
        db.put("k", FBlob(d))
    live, rounds, _ = mark(db.store, db.branches.all_heads())
    assert live == set(db.store.iter_cids())     # nothing is garbage yet
    assert rounds >= 3                           # one get_many per level
    assert db.gc().swept_chunks == 0
    for i, d in enumerate(datas):                # history still readable
        uid = db.track("k", "master")[2 - i].uid
        assert db.get("k", uid=uid).blob().read() == d


def test_mark_batches_one_round_trip_per_level(db, rng):
    db.put("k", FBlob(rng.bytes(120_000)))
    g0 = db.store.stats.get_batches
    _, rounds, _ = mark(db.store, db.branches.all_heads())
    assert db.store.stats.get_batches - g0 == rounds
    assert rounds < len(db.store)                # frontier BFS, not per-chunk


def test_dangling_roots_reported_not_fatal(db, rng):
    """A stale pin (or tag) must not brick collection forever."""
    db.put("k", FBlob(rng.bytes(10_000)))
    db.pins.pin(b"\x01" * 32)                    # never existed
    report = db.gc()
    assert report.missing_roots == 1
    assert db.get("k") is not None
    db.pins.unpin(b"\x01" * 32)
    assert db.gc().missing_roots == 0


def test_fork_from_unknown_uid_raises(db):
    db.put("k", FString(b"x"))
    with pytest.raises(NoSuchRef):
        db.fork("k", b"\x02" * 32, "bad")        # dangling tag refused


def test_gc_after_remove_reclaims_only_unreachable(db, rng):
    shared = rng.bytes(40_000)
    db.put("k", FBlob(shared))
    db.fork("k", "master", "exp")
    db.put("k", FBlob(shared + rng.bytes(10_000)), "exp")  # shares chunks
    db.remove("k", "exp")
    db.gc()
    assert db.get("k").blob().read() == shared   # shared prefix survived


def test_fork_then_remove_is_a_noop_for_foc_heads(db):
    """Tagging an existing untagged head and removing the tag must
    restore the pre-fork state — the racing head stays a GC root."""
    base = db.put("k", FString(b"v1"))
    u = db.put("k", FString(b"racing"), base_uid=base)
    assert u in db.list_untagged_branches("k")
    db.fork("k", u, "tmp")
    db.remove("k", "tmp")
    assert u in db.list_untagged_branches("k")
    db.gc()
    assert db.get("k", uid=u).string().value == b"racing"


def test_remove_aliases_of_foc_head_any_order(rng):
    """Two tags aliasing the same racing head: removing both (either
    order) restores the untagged head — never destroys it."""
    for order in (("b", "c"), ("c", "b")):
        db = ForkBase(MemoryBackend())
        base = db.put("k", FString(b"v1"))
        u = db.put("k", FString(b"racing"), base_uid=base)
        db.fork("k", u, "b")
        db.fork("k", u, "c")
        for br in order:
            db.remove("k", br)
        db.gc()
        assert db.get("k", uid=u).string().value == b"racing"
        assert u in db.list_untagged_branches("k")


def test_merged_untagged_heads_survive_tag_churn(db):
    """An M7 merge of racing heads is itself a genuine untagged head."""
    base = db.put("k", FString(b"v"))
    u1 = db.put("k", FString(b"a"), base_uid=base)
    u2 = db.put("k", FString(b"b"), base_uid=base)
    from repro_torch.core import choose_one
    merged = db.merge("k", u1, u2, resolver=choose_one(0))
    db.fork("k", merged, "tmp")
    db.remove("k", "tmp")
    db.gc()
    assert merged in db.list_untagged_branches("k")
    assert db.get("k", uid=merged) is not None


def test_prune_unknown_branch_raises(rng):
    from repro_torch.ckpt.store import CheckpointStore
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    _run(cs, rng, "run", range(2))
    with pytest.raises(NoSuchRef):
        cs.prune("typo", keep_last=1)


def test_remove_order_does_not_leak(db, rng):
    """Removing origin-then-fork (either order) of a never-advanced fork
    leaves nothing pinned: reclaimability must not depend on removal
    order."""
    for order in (("master", "exp"), ("exp", "master")):
        db = ForkBase(MemoryBackend())
        db.put("k", FBlob(rng.bytes(15_000)))
        db.fork("k", "master", "exp")
        for b in order:
            db.remove("k", b)
        assert db.gc().swept_chunks > 0
        assert len(db.store) == 0


def test_remove_after_branch_advanced_is_collectable(db, rng):
    db.put("k", FString(b"v"))
    db.fork("k", "master", "b")
    db.put("k", FBlob(rng.bytes(20_000)), "b")   # branch advances
    uid = db.get("k", "b").uid
    db.remove("k", "b")
    assert db.gc().swept_chunks > 0
    with pytest.raises(KeyError):
        db.get("k", uid=uid)


def test_gc_respects_foc_untagged_heads(db, rng):
    """Fork-on-conflict heads live in the UB table — they are roots even
    though no tagged branch points at them."""
    base = db.put("k", FString(b"v1"))
    u1 = db.put("k", FString(b"a"), base_uid=base)
    u2 = db.put("k", FString(b"b"), base_uid=base)
    db.gc()
    assert db.get("k", uid=u1).string().value == b"a"
    assert db.get("k", uid=u2).string().value == b"b"


# ------------------------------------------------------------------ pins

def test_pins_shield_detached_versions(db, rng):
    data = rng.bytes(30_000)
    db.put("k", FBlob(data), "tmp")
    uid = db.get("k", "tmp").uid
    db.remove("k", "tmp")
    with db.pins.hold(uid):
        assert db.gc().swept_chunks == 0
        assert db.get("k", uid=uid).blob().read() == data
    report = db.gc()                             # hold released -> swept
    assert report.swept_chunks > 0
    with pytest.raises(KeyError):
        db.get("k", uid=uid)


def test_pinset_refcounts():
    p = PinSet()
    p.pin(b"u1")
    with p.hold(b"u1", b"u2"):
        assert b"u2" in p and len(p) == 2
    assert b"u1" in p and b"u2" not in p         # outer pin survived
    p.unpin(b"u1")
    assert len(p) == 0


# ------------------------------------------------------------- exceptions

def test_typed_branch_errors(db):
    db.put("k", FString(b"x"))
    db.fork("k", "master", "b")
    with pytest.raises(BranchExists):
        db.fork("k", "master", "b")
    with pytest.raises(BranchExists):
        db.rename("k", "master", "b")
    with pytest.raises(NoSuchRef):
        db.fork("k", "ghost", "c")
    with pytest.raises(NoSuchRef):
        db.rename("k", "ghost", "c")
    with pytest.raises(NoSuchRef):
        db.merge("k", "ghost", "master")
    with pytest.raises(NoSuchRef):
        db.merge("k", "master", "ghost")
    assert isinstance(NoSuchRef("x"), KeyError)
    assert isinstance(BranchExists("x"), ValueError)


# ---------------------------------------------------------------- ckpt

def _run(cs, rng, branch, steps, shape=(48, 48)):
    state = {"w": rng.normal(size=shape).astype("float32"),
             "m": rng.normal(size=shape).astype("float32")}
    for step in steps:
        state = {k: v + 0.01 * rng.normal(size=v.shape).astype(v.dtype)
                 for k, v in state.items()}
        cs.save({k: torch.from_numpy(v) for k, v in state.items()}, branch,
                step=step)
    return {k: torch.from_numpy(v) for k, v in state.items()}


def test_ckpt_prune_keep_last_and_every(rng):
    from repro_torch.ckpt.store import CheckpointStore
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    state = _run(cs, rng, "run", range(10))
    n0 = len(cs.db.store)
    phys0 = cs.db.store.stats.physical_bytes
    kept, report = cs.prune("run", keep_last=2, keep_every=4)
    assert report.swept_chunks > 0
    assert len(cs.db.store) < n0
    assert cs.db.store.stats.physical_bytes < phys0
    steps = [c["step"] for _, c in cs.history("run")]
    assert steps == [9, 8, 4, 0]                 # newest 2 + every 4th
    out = cs.restore(state, "run")               # latest: byte-identical
    for k in state:
        assert torch.equal(out[k], state[k])
    cs.restore(state, uid=kept[-1])              # oldest kept still loads


def test_ckpt_prune_spares_forked_experiment(rng):
    from repro_torch.ckpt.store import CheckpointStore
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    _run(cs, rng, "run", range(5))
    fork_uid = cs.history("run")[2][0]           # step 2
    cs.fork(fork_uid, "exp")
    state = _run(cs, rng, "exp", range(3, 6))
    cs.prune("run", keep_last=1)
    # the fork's whole lineage (incl. pre-fork history) stays reachable
    out = cs.restore(state, "exp")
    for k in state:
        assert torch.equal(out[k], state[k])
    assert cs.restore(state, uid=fork_uid) is not None
    # shared history was anchored, not rewritten: the pruned run still
    # shares an ancestor with the fork (merge/lca keep working) and its
    # history walks through the untouched pre-fork versions
    from repro_torch.core import lca
    run_head = cs.db.get(cs.key, "run").uid
    exp_head = cs.db.get(cs.key, "exp").uid
    assert lca(cs.db.store, run_head, exp_head) == fork_uid
    assert [c["step"] for _, c in cs.history("run")] == [4, 2, 1, 0]


def test_ckpt_prune_shared_head_is_noop(rng):
    """Pruning a branch whose head IS the fork point rewrites nothing."""
    from repro_torch.ckpt.store import CheckpointStore
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    _run(cs, rng, "run", range(3))
    cs.fork("run", "twin")                       # same head, no advance
    n0 = len(cs.db.store)
    kept, report = cs.prune("twin", keep_last=1)
    assert kept == []
    assert len(cs.db.store) == n0
    assert [c["step"] for _, c in cs.history("twin")] == [2, 1, 0]


def test_ckpt_hold_blocks_prune_reclaim(rng):
    from repro_torch.ckpt.store import CheckpointStore
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    state = _run(cs, rng, "run", range(4))
    old_uid = cs.history("run")[3][0]            # step 0 manifest
    with cs.hold(old_uid):
        cs.prune("run", keep_last=1)
        cs.restore(state, uid=old_uid)           # still materializes
    cs.db.gc()
    with pytest.raises(KeyError):
        cs.db.get(cs.key, uid=old_uid)


# -------------------------------------------------------------- cluster

def test_cluster_gc_global_roots(rng):
    cl = Cluster(4)
    keep = {}
    for i in range(6):                           # keys land on many servlets
        k = f"key{i}"
        keep[k] = rng.bytes(20_000)
        cl.put(k, FBlob(keep[k]))
        cl.fork(k, "master", "tmp")
        cl.put(k, FBlob(rng.bytes(20_000)), "tmp")
    n0 = len(cl.index)
    for k in keep:
        cl.remove(k, "tmp")
    report = cl.gc()
    assert report.swept_chunks > 0
    assert len(cl.index) < n0
    for k, d in keep.items():                    # every survivor intact
        assert cl.get(k).blob().read() == d
    assert cl.gc().swept_chunks == 0             # idempotent
    # stats stay coherent: node stores and placement counters shrink,
    # nothing is debited into the negative, and the per-servlet
    # routing-store write counters are untouched by the sweep
    for n in cl.nodes:
        assert n.store.stats.physical_bytes >= 0
        assert n.stats.chunk_bytes >= 0 and n.stats.chunks >= 0
        assert n.servlet.store.stats.physical_bytes >= 0
    assert sum(n.stats.chunks for n in cl.nodes) == len(cl.index)


def test_single_servlet_gc_is_cluster_safe(rng):
    """gc() on ONE servlet must union the global root set — other
    servlets' keys survive even though the shared inventory is swept."""
    cl = Cluster(4)
    keep = {}
    for i in range(6):
        keep[f"key{i}"] = rng.bytes(15_000)
        cl.put(f"key{i}", FBlob(keep[f"key{i}"]))
        cl.fork(f"key{i}", "master", "tmp")
        cl.put(f"key{i}", FBlob(rng.bytes(15_000)), "tmp")
        cl.remove(f"key{i}", "tmp")
    report = cl.nodes[0].servlet.gc()      # delegates to Cluster.gc
    assert report.swept_chunks > 0
    for k, d in keep.items():
        assert cl.get(k).blob().read() == d
    # the sweep never skews any servlet's write-side routing counters
    for n in cl.nodes:
        assert n.servlet.store.stats.physical_bytes >= 0


@pytest.mark.parametrize("incremental", [False, True])
def test_cluster_gc_rebases_build_pressure_on_live_bytes(rng, incremental):
    """ROADMAP "GC-aware rebalancing": after a collection — incremental
    or stop-the-world — construction-pressure counters must track the
    post-GC LIVE byte distribution, not gross bytes ever written; a node
    whose data was mostly collected stops repelling new work."""
    from repro_torch.core import ChunkParams
    cl = Cluster(4, "2LP", ChunkParams(q=8))
    for i in range(24):                     # one hot key: skewed pressure
        cl.put("hotkey", FBlob(rng.bytes(30_000)), branch=f"b{i}")
    gross = sum(cl.build_distribution())
    for i in range(1, 24):
        cl.remove("hotkey", f"b{i}")        # most of it becomes garbage
    report = cl.gc(incremental=incremental, budget=32)
    assert report.swept_chunks > 0
    live = [max(0, n.stats.chunk_bytes) for n in cl.nodes]
    assert cl.build_distribution() == live  # rebased on live placement
    assert sum(cl.build_distribution()) < gross
    assert cl.get("hotkey", "b0") is not None


# ------------------------------------------------- property: GC is safe

def _surviving_versions(db, key):
    """Every version reachable from any surviving head (full DAG walk)."""
    out = set()
    frontier = set(db.branches.tagged(key).values())
    frontier |= set(db.branches.untagged(key))
    while frontier:
        uid = frontier.pop()
        if uid in out:
            continue
        out.add(uid)
        from repro_torch.core import load_fobject
        frontier |= set(load_fobject(db.store, uid).bases)
    return out


def test_gc_safety_random_workload():
    """After random put/fork/merge/remove/gc workloads, every version
    reachable from a surviving head round-trips — GC never collects
    live data."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    ops = st.lists(
        st.one_of(
            st.tuples(st.just("put"), st.integers(0, 2), st.binary(
                min_size=1, max_size=4000)),
            st.tuples(st.just("fork"), st.integers(0, 2), st.integers(0, 3)),
            st.tuples(st.just("merge"), st.integers(0, 2),
                      st.integers(0, 3)),
            st.tuples(st.just("remove"), st.integers(0, 2),
                      st.integers(0, 3)),
            st.tuples(st.just("gc"), st.just(0), st.just(0)),
        ), min_size=1, max_size=30)

    @settings(max_examples=25, deadline=None)
    @given(ops)
    def run(seq):
        db = ForkBase(MemoryBackend())
        contents: dict[bytes, bytes] = {}        # uid -> expected payload
        for op, ki, arg in seq:
            key = f"k{ki}".encode()
            branches = sorted(db.branches.tagged(key)) or ["master"]
            if op == "put":
                uid = db.put(key, FBlob(arg),
                             branches[arg[0] % len(branches)]
                             if db.branches.tagged(key) else "master")
                contents[uid] = arg
            elif op == "fork" and db.branches.tagged(key):
                src = branches[arg % len(branches)]
                try:
                    db.fork(key, src, f"b{len(branches)}")
                except BranchExists:
                    pass
            elif op == "merge" and len(branches) >= 2:
                tgt, ref = branches[arg % len(branches)], branches[
                    (arg + 1) % len(branches)]
                if tgt != ref:
                    db.merge(key, tgt, ref,
                             resolver=lambda c: c.ours)
            elif op == "remove" and db.branches.tagged(key):
                db.remove(key, branches[arg % len(branches)])
            elif op == "gc":
                db.gc()
        db.gc()
        for key in db.list_keys():
            for uid in _surviving_versions(db, key):
                h = db.get(key, uid=uid)         # must not raise
                if uid in contents and h.type == FBlob.TYPE:
                    assert h.blob().read() == contents[uid]

    run()
