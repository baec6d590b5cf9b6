"""The live flat-state fast path of the port (repro_torch.live), on the
CPU — LiveDB/ArchiveDB split.

Directed tests for LiveTable semantics (overlay/caches/staleness),
epoch folds (the batched Merkle commitment), engine plumbing
(fork-folds-first, commit_epoch, fence pinning), the attest pin delta
and EpochFence bloom spill, the floating-garbage bound and the live app
modes (ledger, wiki) — plus the equivalence fuzz: random
put/delete/fork/fold/gc interleavings where the folded POS-Tree root
must stay bit-identical to a tree built directly from the model dict,
live-served gets must match the model, and every proof verb must verify
against live-served values.

One rule set drives both a Hypothesis state machine and a seeded numpy
reference fuzzer.  The JAX package's ``tests/test_live.py``, its
cluster routing test included."""
from __future__ import annotations

import os

import numpy as np
import pytest

from repro_torch.core import ChunkParams, FMap, ForkBase, NoSuchRef
from repro_torch.gc import EpochFence, GCPhase
from repro_torch.live import EpochPolicy
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend

try:
    from hypothesis import settings, strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, invariant,
                                     rule, run_state_machine_as_test)
    HAVE_HYPOTHESIS = True
except ImportError:          # dev extra absent: reference fuzzer only
    HAVE_HYPOTHESIS = False

PARAMS = ChunkParams(q=8)        # 256 B target chunks: real trees at test sizes
KEY = b"state"


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def mkdb():
    return ForkBase(MemoryBackend(), PARAMS)


def kv(i: int) -> tuple[bytes, bytes]:
    return f"k{i:05d}".encode(), f"v{i:05d}".encode() * 3


def direct_root(model: dict[bytes, bytes]) -> bytes:
    """Root of a POS-Tree built directly from the model dict in a
    scratch store — the bit-identical reference for folded roots."""
    return FMap(dict(model), params=PARAMS).commit(MemoryBackend())


# --------------------------------------------------------- table basics
def test_live_put_get_delete_fold():
    db = mkdb()
    t = db.live(KEY)
    assert t.get(b"a") is None
    t.put(b"a", b"1")
    t.put(b"b", b"2")
    assert t.get(b"a") == b"1" and t.get(b"b") == b"2"
    assert db.get(KEY) is None                    # nothing folded yet
    rep = t.fold()
    assert rep.folded_keys == 2 and rep.uid is not None
    assert t.dirty_count == 0
    h = db.get(KEY)
    assert h.uid == rep.uid
    assert h.map().get(b"a") == b"1"
    t.delete(b"a")
    assert t.get(b"a") is None                    # overlay delete wins
    rep2 = t.fold()
    assert rep2.deleted_keys == 1
    assert db.get(KEY).map().get(b"a") is None
    assert t.get(b"a") is None                    # negative cache after fold
    # a second table handle is the same object
    assert db.live(KEY) is t
    # empty fold is a no-op
    assert t.fold().uid == rep2.uid and t.stats.folds == 2


def test_live_reads_through_archive():
    db = mkdb()
    t = db.live(KEY)
    for i in range(200):
        k, v = kv(i)
        t.put(k, v)
    t.fold()
    # cold-cache reads are served from the archive tree, then cached
    t._clean.clear()
    t._absent.clear()
    m0 = t.stats.misses
    k, v = kv(77)
    assert t.get(k) == v
    assert t.stats.misses == m0 + 1
    assert t.get(k) == v                          # now cached: a hit
    assert t.stats.misses == m0 + 1
    assert t.load_all() > 0
    assert t.get(kv(3)[0]) == kv(3)[1]


def test_folded_root_bit_identical_to_direct_tree():
    db = mkdb()
    t = db.live(KEY)
    rng = np.random.default_rng(7)
    model: dict[bytes, bytes] = {}
    for i in rng.permutation(300):
        k, v = kv(int(i))
        t.put(k, v)
        model[k] = v
    t.fold()
    for i in range(0, 300, 7):                    # second epoch: mixed delta
        k, _ = kv(i)
        t.delete(k)
        model.pop(k, None)
    for i in range(300, 340):
        k, v = kv(i)
        t.put(k, v)
        model[k] = v
    t.fold()
    assert db.get(KEY).obj.data == direct_root(model)
    assert dict(t.items()) == model


def test_archive_versions_and_history():
    db = mkdb()
    t = db.live(KEY)
    t.put(b"x", b"1")
    u1 = t.fold(context=b"e1").uid
    t.put(b"x", b"2")
    t.put(b"y", b"9")
    u2 = t.fold(context=b"e2").uid
    objs = db.track(KEY, "master")
    assert [o.uid for o in objs] == [u2, u1]
    assert db.get(KEY, uid=u1).map().get(b"x") == b"1"
    assert db.get(KEY, uid=u2).map().get(b"x") == b"2"
    assert db.verify_lineage(u2, u1)


def test_fork_and_merge_fold_first():
    db = mkdb()
    t = db.live(KEY)
    t.put(b"a", b"1")
    db.fork(KEY, "master", "dev")                 # dirty head folds first
    assert t.dirty_count == 0
    assert db.get(KEY, "dev").map().get(b"a") == b"1"
    td = db.live(KEY, "dev")
    td.put(b"b", b"2")
    t.put(b"c", b"3")
    db.merge(KEY, "master", "dev")                # both inputs fold first
    assert t.dirty_count == 0 and td.dirty_count == 0
    m = db.get(KEY).map()
    assert (m.get(b"a"), m.get(b"b"), m.get(b"c")) == (b"1", b"2", b"3")


def test_external_put_revalidates_keeping_overlay():
    db = mkdb()
    t = db.live(KEY)
    t.put(b"a", b"1")
    t.fold()
    t.put(b"b", b"overlay")                       # dirty across the move
    m = db.get(KEY).map()
    m.set(b"c", b"external")
    db.put(KEY, m)                                # head moves under the table
    assert t.get(b"c") == b"external"             # revalidated read-through
    assert t.get(b"b") == b"overlay"              # overlay survived
    assert t.stats.revalidations >= 1
    t.fold()
    final = db.get(KEY).map()
    assert (final.get(b"a"), final.get(b"b"), final.get(b"c")) == \
        (b"1", b"overlay", b"external")


def test_epoch_policy_auto_fold():
    db = mkdb()
    t = db.live(KEY, policy=EpochPolicy(max_dirty_keys=4,
                                        max_dirty_bytes=None))
    for i in range(4):
        t.put(*kv(i))
    assert t.stats.auto_folds == 1 and t.dirty_count == 0
    db2 = mkdb()
    t2 = db2.live(KEY, policy=EpochPolicy(max_dirty_keys=None,
                                          max_dirty_bytes=64))
    t2.put(b"big", b"x" * 100)
    assert t2.stats.auto_folds == 1 and t2.stats.dirty_bytes == 0


def test_rename_and_remove_live_registry():
    db = mkdb()
    t = db.live(KEY)
    t.put(b"a", b"1")
    t.fold()
    db.rename(KEY, "master", "main")
    assert db.live(KEY, "main") is t and t.branch == "main"
    t.put(b"b", b"2")
    db.remove(KEY, "main")                        # unfolded delta dies too
    t2 = db.live(KEY, "main")
    assert t2 is not t and t2.get(b"b") is None


def test_commit_epoch_folds_pins_and_attests():
    db = mkdb()
    ta = db.live(b"ka")
    tb = db.live(b"kb", "master")
    ta.put(b"x", b"1")
    tb.put(b"y", b"2")
    db.live(b"kc")                                # clean table: not folded
    p0 = db.gc_fence.pin_count()
    rep = db.commit_epoch(context=b"epoch", attest=True, secret=b"s")
    assert len(rep.folds) == 2 and rep.folded_keys == 2
    assert sorted(f.key for f in rep.folds) == [b"ka", b"kb"]
    # folded heads pinned under the fence handshake (attest pins more)
    assert db.gc_fence.pin_count() >= p0 + 2
    assert rep.attestation is not None
    from repro_torch.proof.attest import verify_attestation
    verify_attestation(rep.attestation, secret=b"s")
    # the folds are durable heads
    assert db.get(b"ka").map().get(b"x") == b"1"
    assert db.get(b"kb").map().get(b"y") == b"2"


# ------------------------------------------------- attest pin delta path
def test_attest_pins_only_dirty_heads_after_baseline():
    db = mkdb()
    from repro_torch.core import FBlob
    for i in range(12):
        db.put(f"key{i}".encode(), FBlob(b"v" * 40))
    db.attest()                                   # baseline: all heads
    base = db.gc_fence.pin_count()
    assert base >= 12
    db.put(b"key3", FBlob(b"w" * 40))             # one dirty key
    db.attest()
    delta = db.gc_fence.pin_count() - base
    # O(heads of the one dirty key), not O(all heads)
    assert 1 <= delta <= 2
    # a collection advances the fence epoch -> next attest re-baselines
    db.gc(incremental=True, budget=64)
    db.put(b"key5", FBlob(b"z" * 40))
    db.attest()
    assert db.gc_fence.pin_count() >= 12


def test_epoch_fence_bloom_spill_bounds_pin_memory():
    uids = [bytes([i]) * 32 for i in range(1, 9)]
    fence = EpochFence(max_pins=3)
    fence.heads_fn = lambda: uids                 # all still current heads
    fence.pin(uids)
    assert fence.pin_count() == 8                 # 3 exact + 5 spilled
    assert len(fence._pins[fence.epoch]) == 3     # memory bound holds
    roots = fence.grace_roots()
    assert set(uids) <= roots                     # spilled pins recovered
    # a spilled pin that is NO LONGER a head is not recovered (the
    # documented trade); an exact pin survives regardless
    fence.heads_fn = lambda: uids[:4]
    roots = fence.grace_roots()
    assert set(uids[:3]) <= roots and uids[3] in roots
    assert not (set(uids[5:]) & roots)
    # expiry drops bloom state with the epoch
    fence.begin_epoch()
    fence.begin_epoch()
    assert fence.pin_count(0) == 0 and not fence._blooms


# ------------------------------------------------ floating-garbage bound
def test_floating_garbage_counted_across_epochs():
    from repro_torch.core import FBlob
    db = mkdb()
    db.put(b"keep", FBlob(b"K" * 600))
    db.put(b"doomed", FBlob(b"D" * 600))
    r1 = db.gc(incremental=True, budget=32)
    assert r1.floating_garbage == 0               # no previous epoch
    db.remove(b"doomed", "master")                # orphan a marked-live head
    r2 = db.gc(incremental=True, budget=32)
    assert r2.swept_chunks > 0
    # everything swept now was live last epoch: pure floating garbage
    assert r2.floating_garbage == r2.swept_chunks
    r3 = db.gc(incremental=True, budget=32)
    assert r3.floating_garbage == 0


# -------------------------------------------- proof verbs vs live values
def test_proof_verbs_verify_against_live_values():
    from repro_torch.proof import verify_member
    db = mkdb()
    t = db.live(KEY)
    for i in range(120):
        t.put(*kv(i))
    t.delete(kv(60)[0])
    t.fold()
    root = db.get(KEY).obj.data
    for i in (0, 13, 59, 119):
        k, _ = kv(i)
        claim = verify_member(root, db.prove_member(KEY, item_key=k))
        assert claim.key == k and claim.value == t.get(k)
    gone = kv(60)[0]
    assert t.get(gone) is None
    claim = verify_member(root, db.prove_absence(KEY, item_key=gone))
    assert claim.key == gone


# ------------------------------------------------------------- app modes
def test_ledger_live_mode_matches_archival():
    from repro_torch.apps import ForkBaseLedger
    from repro_torch.apps.blockchain import LightClient
    arch = ForkBaseLedger(mkdb())
    live = ForkBaseLedger(mkdb(), live=True)
    for led in (arch, live):
        led.write("bank", "alice", b"100")
        led.write("bank", "bob", b"50")
        led.commit()
        led.write("bank", "alice", b"75")
        led.write("mkt", "gold", b"1900")
        led.commit()
    assert live.read("bank", "alice") == b"75"
    assert live.block_scan(0) == arch.block_scan(0)
    assert live.block_scan(1) == arch.block_scan(1)
    assert [v for _, v in live.state_scan("bank", "alice")] == \
        [v for _, v in arch.state_scan("bank", "alice")]
    assert live.verify_block(0)
    # flat state proof closes against a light client's trusted head
    proof = live.prove_state_flat("bank", "alice")
    client = LightClient(live.db.get("chain").uid)
    dist, val = client.verify_state_flat(proof, "bank", "alice")
    assert (dist, val) == (0, b"75")
    old = live.prove_state_flat("bank", "alice", height=0)
    assert client.verify_state_flat(old, "bank", "alice") == (1, b"100")
    from repro_torch.proof import InvalidProof
    with pytest.raises(InvalidProof):
        client.verify_state_flat(proof, "bank", "bob")


def test_live_wiki_epoch_history():
    from repro_torch.apps import LiveWiki
    w = LiveWiki(mkdb())
    w.create("Page", b"draft " * 60)
    assert w.load("Page") == b"draft " * 60
    w.fold()
    w.edit("Page", b"final " * 60)
    w.fold()
    assert w.read_version("Page", 0) == b"final " * 60
    assert w.read_version("Page", 1) == b"draft " * 60


def test_cluster_live_routing():
    from repro_torch.core.cluster import Cluster
    cluster = Cluster(3, "2LP", PARAMS)
    keys = [f"ck{i}".encode() for i in range(6)]
    for i, k in enumerate(keys):
        cluster.live(k).put(b"n", str(i).encode())
    reps = cluster.commit_epoch(context=b"e0")
    assert sum(len(r.folds) for r in reps) == len(keys)
    for i, k in enumerate(keys):
        assert cluster.get(k).map().get(b"n") == str(i).encode()
        assert cluster.live(k).get(b"n") == str(i).encode()


# ------------------------------------------------------ equivalence fuzz
class LiveWorkload:
    """Shared rule set: live-table traffic + folds + forks + GC slices
    over one engine, with per-op model equivalence and per-fold root
    bit-identity checks."""

    def __init__(self):
        self.db = mkdb()
        self.models: dict[str, dict[bytes, bytes]] = {"master": {}}
        self.col = None
        self.nfork = 0

    def _branch(self, pick: int) -> str:
        bs = sorted(self.models)
        return bs[pick % len(bs)]

    # ---------------------------------------------------------- mutators
    def put(self, pick: int, ki: int, payload: bytes):
        b = self._branch(pick)
        k, _ = kv(ki)
        self.db.live(KEY, b).put(k, payload)
        self.models[b][k] = payload

    def delete(self, pick: int, ki: int):
        b = self._branch(pick)
        k, _ = kv(ki)
        self.db.live(KEY, b).delete(k)
        self.models[b].pop(k, None)

    def fold(self, pick: int):
        b = self._branch(pick)
        self.db.live(KEY, b).fold()

    def fork(self, pick: int):
        if len(self.models) >= 4:
            return
        src = self._branch(pick)
        t = self.db.live(KEY, src)
        if t.dirty_count == 0 and \
                self.db.branches.head(KEY, src) is None:
            return                                 # nothing to fork yet
        self.nfork += 1
        new = f"b{self.nfork}"
        try:
            self.db.fork(KEY, src, new)
        except NoSuchRef:
            return
        self.models[new] = dict(self.models[src])

    def gc_step(self, budget: int):
        if self.col is None or not self.col.active:
            self.col = self.db.incremental_gc()
        self.col.step(budget)

    def gc_full(self):
        # drain an in-flight collection instead of stacking a second
        # concurrent epoch on the same store
        if self.col is not None and self.col.active:
            while self.col.step(64) is not GCPhase.DONE:
                pass
            self.col = None
            return
        self.db.gc(incremental=True, budget=64)

    # ---------------------------------------------------------- checks
    def check_serving(self):
        """Live gets match the model on every branch, hit or miss."""
        for b, model in self.models.items():
            t = self.db.live(KEY, b)
            for k in list(model)[:6]:
                assert t.get(k) == model[k], (b, k)
            assert t.get(b"\xffmissing") is None

    def check_roots(self):
        """Fold every branch: each folded root must be bit-identical to
        a tree built directly from the model dict, and proofs against it
        must verify live-served values."""
        from repro_torch.proof import verify_member
        for b, model in sorted(self.models.items()):
            t = self.db.live(KEY, b)
            t.fold()
            h = self.db.get(KEY, b)
            if h is None:
                assert not model, b
                continue
            assert h.obj.data == direct_root(model), b
            for k in list(model)[:3]:
                claim = verify_member(
                    h.obj.data, self.db.prove_member(KEY, b, item_key=k))
                assert claim.value == t.get(k), (b, k)

    def finish(self):
        while self.col is not None and self.col.active:
            self.col.step(64)
        self.check_roots()
        self.check_serving()


def _payloads(rng):
    n = int(rng.integers(1, 60))
    return bytes(rng.integers(97, 123, size=n, dtype=np.uint8))


def test_live_equivalence_reference_fuzz():
    """Seeded fuzz over the shared rule set — tier-1's hypothesis-free
    twin of the state machine below."""
    for seed in range(8):
        rng = np.random.default_rng(seed)
        w = LiveWorkload()
        for _ in range(120):
            op = int(rng.integers(0, 100))
            pick = int(rng.integers(0, 4))
            if op < 45:
                w.put(pick, int(rng.integers(0, 80)), _payloads(rng))
            elif op < 60:
                w.delete(pick, int(rng.integers(0, 80)))
            elif op < 72:
                w.fold(pick)
            elif op < 80:
                w.fork(pick)
            elif op < 92:
                w.gc_step(int(rng.integers(1, 48)))
            else:
                w.gc_full()
            w.check_serving()
        w.finish()


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_live_equivalence_state_machine():
    n = int(os.environ.get("LIVE_FUZZ_EXAMPLES", "25"))

    class LiveMachine(RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.w = LiveWorkload()

        @rule(pick=st.integers(0, 3), ki=st.integers(0, 80),
              payload=st.binary(min_size=1, max_size=60))
        def put(self, pick, ki, payload):
            self.w.put(pick, ki, payload)

        @rule(pick=st.integers(0, 3), ki=st.integers(0, 80))
        def delete(self, pick, ki):
            self.w.delete(pick, ki)

        @rule(pick=st.integers(0, 3))
        def fold(self, pick):
            self.w.fold(pick)

        @rule(pick=st.integers(0, 3))
        def fork(self, pick):
            self.w.fork(pick)

        @rule(budget=st.integers(1, 48))
        def gc_step(self, budget):
            self.w.gc_step(budget)

        @rule()
        def gc_full(self):
            self.w.gc_full()

        @invariant()
        def serving_matches_model(self):
            self.w.check_serving()

        def teardown(self):
            self.w.finish()

    run_state_machine_as_test(
        LiveMachine,
        settings=settings(max_examples=n, stateful_step_count=40,
                          deadline=None))


def test_gc_phase_exported_for_interleaving():
    # the fuzz drives collections through the public phase enum
    assert GCPhase.MARK is not GCPhase.SWEEP
