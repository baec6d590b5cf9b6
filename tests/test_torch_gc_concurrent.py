"""Incremental concurrent GC safety — a stateful interleaving harness.

The property under test is the whole point of the tri-color design:
interleave put/fork/merge/remove/truncate/pin with collection slices
(``IncrementalCollector.step``) at random budgets, and after EVERY rule
every chunk reachable from any branch head or pin is still readable and
hash-verifies.  Barrier holes — a dedup put adopting a condemned chunk
mid-sweep, a fork re-rooting a detached subgraph mid-mark — show up as
concrete traces.

One rule set (``GCWorkload``) drives two harnesses:

  * a Hypothesis ``RuleBasedStateMachine`` (when the dev extra is
    installed — CI's fuzz job runs it at >= 500 examples), which
    shrinks any failure to a minimal op sequence;
  * a seeded reference fuzzer over the same ops that needs nothing
    beyond numpy, so the tier-1 suite exercises the interleavings even
    without the dev extra.

Also here: the deterministic pause-bound property (``step(budget=k)``
touches at most k chunks per call, mark and sweep alike, measured by a
counting store wrapper) and directed regressions for the root-barrier
rescue paths.

The port's copy (repro_torch.gc, on the CPU) of the JAX package's
``tests/test_gc_concurrent.py``, its cluster test included.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch.core import BranchExists, ChunkParams, FBlob, ForkBase
from repro_torch.core.chunk import cid_of
from repro_torch.core.merge import MergeConflict
from repro_torch.gc import GCPhase, mark
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend

try:
    from hypothesis import settings, strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, invariant,
                                     rule, run_state_machine_as_test)
    HAVE_HYPOTHESIS = True
except ImportError:          # dev extra absent: reference fuzzer only
    HAVE_HYPOTHESIS = False



@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


KEYS = [b"k0", b"k1", b"k2"]
PARAMS = ChunkParams(q=8)        # 256 B target chunks: real trees at test sizes


class GCWorkload:
    """The shared rule set: mutator traffic + collection slices over one
    engine, with the safety invariant both harnesses check after every
    op."""

    def __init__(self):
        self.db = ForkBase(MemoryBackend(), PARAMS)
        self.col = None
        self.contents: dict[bytes, bytes] = {}   # uid -> expected payload
        self.pinned: list[bytes] = []

    # ---------------------------------------------------------- helpers
    def _branches(self, key):
        return sorted(self.db.branches.tagged(key))

    def _versions(self, key, branch):
        return [o.uid for o in self.db.track(key, branch)]

    # ---------------------------------------------------------- mutators
    def put(self, ki: int, data: bytes, pick: int):
        key = KEYS[ki]
        bs = self._branches(key)
        uid = self.db.put(key, FBlob(data),
                          bs[pick % len(bs)] if bs else "master")
        self.contents[uid] = data

    def fork_branch(self, ki: int, pick: int):
        key = KEYS[ki]
        bs = self._branches(key)
        if not bs:
            return
        try:
            self.db.fork(key, bs[pick % len(bs)], f"b{len(bs)}")
        except BranchExists:
            pass

    def fork_from_version(self, ki: int, pick: int, depth: int):
        """Re-root a historical version by uid (root-barrier path)."""
        key = KEYS[ki]
        bs = self._branches(key)
        if not bs:
            return
        uids = self._versions(key, bs[pick % len(bs)])
        if not uids:
            return
        try:
            self.db.fork(key, uids[depth % len(uids)], f"v{len(bs)}")
        except BranchExists:
            pass

    def merge_branches(self, ki: int, pick: int):
        key = KEYS[ki]
        bs = self._branches(key)
        if len(bs) < 2:
            return
        tgt = bs[pick % len(bs)]
        ref = bs[(pick + 1) % len(bs)]
        if tgt != ref:
            try:
                self.db.merge(key, tgt, ref, resolver=lambda c: c.ours)
            except MergeConflict:
                pass     # truncate can orphan ancestry: merge refused

    def remove_branch(self, ki: int, pick: int):
        key = KEYS[ki]
        bs = self._branches(key)
        if bs:
            self.db.remove(key, bs[pick % len(bs)])

    def truncate(self, ki: int, pick: int, n: int):
        key = KEYS[ki]
        bs = self._branches(key)
        if not bs:
            return
        branch = bs[pick % len(bs)]
        chain = self._versions(key, branch)
        if len(chain) < 2:
            return
        mapping = self.db.truncate_history(key, branch, chain[:n])
        for old, new in mapping.items():
            if old in self.contents:       # rewritten meta, same payload
                self.contents[new] = self.contents[old]

    def pin_version(self, ki: int, pick: int, depth: int):
        """In-flight reader: pin a reachable version (root barrier)."""
        key = KEYS[ki]
        bs = self._branches(key)
        if not bs:
            return
        uids = self._versions(key, bs[pick % len(bs)])
        if uids:
            uid = uids[depth % len(uids)]
            self.db.pins.pin(uid)
            self.pinned.append(uid)

    def unpin(self):
        if self.pinned:
            self.db.pins.unpin(self.pinned.pop())

    # ---------------------------------------------------------- collector
    def gc_begin(self):
        if self.col is None or not self.col.active:
            self.col = self.db.incremental_gc()

    def gc_step(self, budget: int):
        if self.col is not None and self.col.active:
            self.col.step(budget)

    def gc_stop_the_world(self):
        # collections are serialized: STW only runs between epochs
        if self.col is None or not self.col.active:
            self.db.gc()

    # ---------------------------------------------------------- invariant
    def check_invariant(self):
        roots = self.db.branches.all_heads() | self.db.pins.uids()
        live, _, missing = mark(self.db.store, roots)
        assert missing == 0, "a head/pin root was swept"
        for cid in live:
            # repro: allow(PERF001): invariant checker reads one cid at
            # a time so the failing cid is named in the assert
            raw = self.db.store.get(cid)       # readable (not swept)
            assert cid_of(raw) == cid          # and hash-verifies
        for key in self.db.list_keys():
            heads = set(self.db.branches.tagged(key).values())
            heads |= set(self.db.branches.untagged(key))
            for uid in heads:
                if uid in self.contents:       # payload round-trips
                    h = self.db.get(key, uid=uid)
                    assert h.blob().read() == self.contents[uid]


# ------------------------------------------- seeded reference fuzzer

def _random_op(w: GCWorkload, rng) -> None:
    op = rng.integers(0, 100)
    ki = int(rng.integers(0, 3))
    pick = int(rng.integers(0, 8))
    if op < 30:
        w.put(ki, rng.bytes(int(rng.integers(1, 1500))), pick)
    elif op < 38:
        w.fork_branch(ki, pick)
    elif op < 46:
        w.fork_from_version(ki, pick, int(rng.integers(0, 5)))
    elif op < 54:
        w.merge_branches(ki, pick)
    elif op < 64:
        w.remove_branch(ki, pick)
    elif op < 70:
        w.truncate(ki, pick, int(rng.integers(1, 3)))
    elif op < 76:
        w.pin_version(ki, pick, int(rng.integers(0, 5)))
    elif op < 80:
        w.unpin()
    elif op < 86:
        w.gc_begin()
    elif op < 97:
        w.gc_step(int(rng.integers(1, 41)))
    else:
        w.gc_stop_the_world()


def _run_reference_fuzz(episodes: int, steps: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(episodes):
        w = GCWorkload()
        for _ in range(steps):
            _random_op(w, rng)
            w.check_invariant()


def test_gc_interleaving_reference_fuzz():
    _run_reference_fuzz(episodes=40, steps=30, seed=0)


@pytest.mark.slow
def test_gc_interleaving_reference_fuzz_deep():
    _run_reference_fuzz(
        episodes=int(os.environ.get("GC_FUZZ_EPISODES", "500")),
        steps=40, seed=1)


# ------------------------------------------- hypothesis state machine

if HAVE_HYPOTHESIS:
    class GCInterleaving(RuleBasedStateMachine):
        """The same rule set, driven (and shrunk) by Hypothesis."""

        def __init__(self):
            super().__init__()
            self.w = GCWorkload()

        @rule(ki=st.integers(0, 2),
              data=st.binary(min_size=1, max_size=1500),
              pick=st.integers(0, 7))
        def put(self, ki, data, pick):
            self.w.put(ki, data, pick)

        @rule(ki=st.integers(0, 2), pick=st.integers(0, 7))
        def fork_branch(self, ki, pick):
            self.w.fork_branch(ki, pick)

        @rule(ki=st.integers(0, 2), pick=st.integers(0, 7),
              depth=st.integers(0, 4))
        def fork_from_version(self, ki, pick, depth):
            self.w.fork_from_version(ki, pick, depth)

        @rule(ki=st.integers(0, 2), pick=st.integers(0, 7))
        def merge_branches(self, ki, pick):
            self.w.merge_branches(ki, pick)

        @rule(ki=st.integers(0, 2), pick=st.integers(0, 7))
        def remove_branch(self, ki, pick):
            self.w.remove_branch(ki, pick)

        @rule(ki=st.integers(0, 2), pick=st.integers(0, 7),
              n=st.integers(1, 2))
        def truncate(self, ki, pick, n):
            self.w.truncate(ki, pick, n)

        @rule(ki=st.integers(0, 2), pick=st.integers(0, 7),
              depth=st.integers(0, 4))
        def pin_version(self, ki, pick, depth):
            self.w.pin_version(ki, pick, depth)

        @rule()
        def unpin(self):
            self.w.unpin()

        @rule()
        def gc_begin(self):
            self.w.gc_begin()

        @rule(budget=st.integers(1, 40))
        def gc_step(self, budget):
            self.w.gc_step(budget)

        @rule()
        def gc_stop_the_world(self):
            self.w.gc_stop_the_world()

        @invariant()
        def every_reachable_chunk_readable_and_hash_verifies(self):
            self.w.check_invariant()

    GCInterleaving.TestCase.settings = settings(
        max_examples=50, stateful_step_count=30, deadline=None)
    TestGCInterleaving = GCInterleaving.TestCase

    @pytest.mark.slow
    def test_gc_interleaving_fuzz():
        """Scheduled CI fuzz: the same machine at >= 500 examples and
        longer op sequences (GC_FUZZ_EXAMPLES overrides)."""
        examples = int(os.environ.get("GC_FUZZ_EXAMPLES", "500"))
        run_state_machine_as_test(
            GCInterleaving,
            settings=settings(max_examples=examples,
                              stateful_step_count=40, deadline=None))


# ------------------------------------------------------- pause bound


class TouchCountingBackend(MemoryBackend):
    """Counts chunk *touches* — payload reads and deletions — so a test
    can bound the work one collection slice does.  (``has_many`` /
    ``iter_cids`` are presence probes, not chunk touches.)"""

    def __init__(self):
        super().__init__()
        self.touched = 0

    def get_many(self, cids):
        self.touched += len(cids)
        return super().get_many(cids)

    def delete_many(self, cids):
        self.touched += len(cids)
        return super().delete_many(cids)


@pytest.mark.parametrize("budget", [1, 7, 32])
def test_step_touches_at_most_budget_chunks(budget, rng):
    """Deterministic pause bound: across BOTH phases, one step(budget=k)
    never reads or deletes more than k chunks."""
    store = TouchCountingBackend()
    db = ForkBase(store, PARAMS)
    db.put("k", FBlob(rng.bytes(30_000)))
    db.fork("k", "master", "tmp")
    db.put("k", FBlob(rng.bytes(150_000)), "tmp")
    db.remove("k", "tmp")                       # garbage for the sweep
    col = db.incremental_gc()
    while col.phase is not GCPhase.DONE:
        store.touched = 0
        col.step(budget)
        assert store.touched <= budget
    assert col.report.mark_rounds > 1           # mark actually sliced
    assert col.report.swept_chunks > budget     # sweep actually sliced
    assert db.get("k") is not None


def test_step_rejects_nonpositive_budget(rng):
    db = ForkBase(MemoryBackend(), PARAMS)
    db.put("k", FBlob(rng.bytes(2_000)))
    col = db.incremental_gc()
    with pytest.raises(ValueError):
        col.step(0)
    col.collect()


# ------------------------------------------------- root-barrier rescues


def test_fork_from_detached_uid_mid_sweep_rescues_subgraph(rng):
    """Re-rooting a condemned subgraph mid-sweep must transitively
    rescue every chunk of it, not just the head meta chunk."""
    db = ForkBase(MemoryBackend(), PARAMS)
    data = rng.bytes(20_000)
    uid = db.put("k", FBlob(data), "tmp")
    db.remove("k", "tmp")                       # fully detached
    col = db.incremental_gc()
    while col.step(8) is GCPhase.MARK:
        pass
    assert col.phase is GCPhase.SWEEP           # condemned, nothing swept yet
    db.fork("k", uid, "back")                   # root barrier fires
    while col.step(8) is not GCPhase.DONE:
        pass
    assert col.report.barriered > 0
    assert db.get("k", "back").blob().read() == data


def test_pin_mid_sweep_rescues_subgraph(rng):
    db = ForkBase(MemoryBackend(), PARAMS)
    data = rng.bytes(20_000)
    uid = db.put("k", FBlob(data), "tmp")
    db.remove("k", "tmp")
    col = db.incremental_gc()
    while col.step(8) is GCPhase.MARK:
        pass
    db.pins.pin(uid)                            # in-flight reader arrives
    while col.step(8) is not GCPhase.DONE:
        pass
    assert db.get("k", uid=uid).blob().read() == data
    db.pins.unpin(uid)
    assert db.gc().swept_chunks > 0             # next epoch reclaims it


def test_collections_are_serialized(rng):
    db = ForkBase(MemoryBackend(), PARAMS)
    db.put("k", FBlob(rng.bytes(5_000)))
    col = db.incremental_gc()
    with pytest.raises(RuntimeError):
        col.begin()
    col.collect()
    assert col.begin() == 2                     # reusable across epochs
    col.collect()


def test_pin_mid_sweep_rescues_through_gc_hooks(rng):
    """The transitive mid-sweep rescue must follow application-level
    link extractors too: a checkpoint manifest's tensor-tree roots live
    only in its JSON values (``manifest_refs``), and pinning a condemned
    checkpoint must rescue the tensors, not just the manifest chain."""
    from repro_torch.ckpt.store import CheckpointStore
    cs = CheckpointStore(ForkBase(MemoryBackend()))
    state = {"w": torch.from_numpy(
        rng.normal(size=(48, 48)).astype("float32"))}
    uid = cs.save(state, "run", step=0)
    cs.db.remove(cs.key, "run")                 # whole run condemned
    col = cs.db.incremental_gc()
    while col.step(8) is GCPhase.MARK:
        pass
    assert col.phase is GCPhase.SWEEP
    cs.db.pins.pin(uid)                         # late reader pins the ckpt
    while col.step(8) is not GCPhase.DONE:
        pass
    out = cs.restore(state, uid=uid)            # tensors fully readable
    assert torch.equal(out["w"], state["w"])


def test_external_engine_root_barrier_reaches_cluster_collection(rng):
    """An external ForkBase sharing a servlet's routing store begins the
    collection; its own fork-from-uid mid-sweep must still rescue."""
    from repro_torch.core import Cluster
    cl = Cluster(3)
    db = ForkBase(cl.nodes[0].servlet.store)    # external committer
    data = rng.bytes(20_000)
    uid = db.put("k", FBlob(data), "tmp")
    db.remove("k", "tmp")                       # detached
    col = db.incremental_gc()                   # delegates to the cluster
    while col.step(8) is GCPhase.MARK:
        pass
    assert col.phase is GCPhase.SWEEP
    db.fork("k", uid, "back")                   # external root barrier
    while col.step(8) is not GCPhase.DONE:
        pass
    assert db.get("k", "back").blob().read() == data


def test_root_barrier_counts_only_present_rescues(rng):
    """Regression: the transitive mid-sweep rescue used to count every
    frontier cid in report.barriered, including cids the store no
    longer holds — which were never going to be deleted and were never
    'rescued' from anything."""
    db = ForkBase(MemoryBackend(), PARAMS)
    uid = db.put("k", FBlob(rng.bytes(20_000)), "tmp")
    db.remove("k", "tmp")                       # fully detached
    col = db.incremental_gc()
    while col.step(8) is GCPhase.MARK:
        pass
    assert col.phase is GCPhase.SWEEP
    # one condemned chunk silently vanishes (lost replica / bit-rot
    # delete) while STAYING in the condemned set
    from repro_torch.gc import chunk_refs
    victim = next(c for c in sorted(col._condemned_set)
                  if c != uid and not chunk_refs(db.store._data[c]))
    del db.store._data[victim]          # a leaf: the rest stays connected
    expected = sum(1 for c in col._condemned_set
                   if c in db.store._data)
    db.fork("k", uid, "back")                   # transitive rescue
    assert col.report.barriered == expected     # pre-fix: expected + 1
    while col.step(8) is not GCPhase.DONE:
        pass


def test_freeze_consumes_inventory_in_budget_slices(rng):
    """Sliced inventory freeze: the MARK->SWEEP transition
    must consume at most ``budget`` inventory cids per step instead of
    filtering the whole store in one pause."""
    from repro_torch.gc import IncrementalCollector
    store = MemoryBackend()
    db = ForkBase(store, PARAMS)
    db.put("k", FBlob(rng.bytes(40_000)))
    db.put("k", FBlob(rng.bytes(40_000)), "tmp")
    db.remove("k", "tmp")
    consumed = {"n": 0}

    def counting_inventory():
        def gen():
            for cid in store.iter_cids():
                consumed["n"] += 1
                yield cid
        return gen()

    col = IncrementalCollector(store, branches=db.branches,
                               inventory_fn=counting_inventory)
    col.begin()
    budget = 16
    freeze_slices = 0
    while col.phase is GCPhase.MARK:
        before = consumed["n"]
        col.step(budget)
        took = consumed["n"] - before
        assert took <= budget                   # bounded pause per slice
        if took:
            freeze_slices += 1
    n_inventory = len(store)
    assert consumed["n"] >= n_inventory         # whole inventory seen
    assert freeze_slices >= (n_inventory + budget - 1) // budget
    while col.step(budget) is not GCPhase.DONE:
        pass
    assert db.get("k").blob() is not None       # live value intact
    assert col.report.swept_chunks > 0          # garbage reclaimed


def test_put_during_freeze_is_not_condemned(rng):
    """A chunk put (or dedup-adopted) while the inventory freeze is in
    progress must never enter the condemned set — the barrier keeps
    MARK semantics until SWEEP actually begins."""
    db = ForkBase(MemoryBackend(), PARAMS)
    data = rng.bytes(30_000)
    db.put("k", FBlob(data), "tmp")
    db.remove("k", "tmp")                       # detached: all condemned
    db.put("other", FBlob(rng.bytes(30_000)))   # live ballast to mark
    col = db.incremental_gc()
    while col.phase is GCPhase.MARK and col._inv_iter is None:
        col.step(1)                             # reach the freeze window
    assert col.phase is GCPhase.MARK and col._inv_iter is not None
    uid = db.put("k", FBlob(data))              # dedups onto condemned
    while col.step(1) is not GCPhase.DONE:
        pass
    assert db.get("k", uid=uid).blob().read() == data


def test_finished_collectors_do_not_accumulate(rng):
    db = ForkBase(MemoryBackend())
    for _ in range(5):
        db.put("k", FBlob(rng.bytes(3_000)))
        db.gc(incremental=True, budget=16)
    assert len(db.gc_collectors) == 1           # finished epochs dropped
    assert db.gc_collectors[0].marked == frozenset()   # O(live) set freed


def test_mid_mark_remove_is_floating_garbage_not_unsafe(rng):
    """A branch removed after the snapshot stays live THIS epoch (its
    chunks were snapshot roots) and falls in the next — never a use-
    after-sweep, never a leak."""
    db = ForkBase(MemoryBackend(), PARAMS)
    keep = rng.bytes(15_000)
    db.put("k", FBlob(keep))
    db.fork("k", "master", "tmp")
    db.put("k", FBlob(rng.bytes(15_000)), "tmp")
    col = db.incremental_gc()
    col.step(4)
    db.remove("k", "tmp")                       # mid-mark removal
    while col.step(16) is not GCPhase.DONE:
        pass
    assert col.report.swept_chunks == 0         # floating this epoch
    assert db.gc().swept_chunks > 0             # reclaimed next epoch
    assert db.get("k").blob().read() == keep
