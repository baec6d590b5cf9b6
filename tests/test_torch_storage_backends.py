"""Backend conformance of the port (repro_torch.storage), on the CPU: the
shared put/get/has/delete/dedup/stats suite of the JAX package's
``tests/test_storage_backends.py`` over every ported StorageBackend
(memory, log, LRU, replicated, sharded, cluster routing, durable segment,
tiered), with
the verified and tamper variants, the log replay and write-buffer tests,
``make_backend`` and the fphash dispatch.

The GC tests run through every stack too: a stop-the-world collection,
a put landing mid-mark and a dedup put landing mid-sweep (the race the
parked barrier lock closes).  Hypothesis properties run as seeded
loops.
"""
import itertools

import numpy as np
import pytest

from repro_torch.core import Cluster, ForkBase, FBlob, FMap
from repro_torch.core.chunk import cid_of, encode_chunk
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.storage import (ChunkMissing, LRUCacheBackend,
                                 MemoryBackend, ReplicatedBackend,
                                 SegmentBackend, ShardedBackend,
                                 StorageBackend, TamperedChunk,
                                 TieredBackend, WriteBuffer, make_backend)
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

BACKENDS = ["memory", "log", "lru", "replicated", "sharded", "routing",
            "segment", "tiered"]


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@pytest.fixture
def backend(request, tmp_path):
    name = request.param
    if name == "memory":
        return MemoryBackend()
    if name == "log":
        return MemoryBackend(log_path=str(tmp_path / "chunks.log"))
    if name == "lru":
        return LRUCacheBackend(MemoryBackend(), capacity_bytes=1 << 20)
    if name == "replicated":
        return ReplicatedBackend([MemoryBackend() for _ in range(3)], k=2)
    if name == "sharded":
        return ShardedBackend(4)
    if name == "routing":
        return Cluster(3).nodes[0].servlet.store
    # small segments / hot tier so multi-segment sealing, demotion and
    # promotion all run inside the shared suite
    if name == "segment":
        return SegmentBackend(str(tmp_path / "segs"), segment_bytes=8 << 10)
    if name == "tiered":
        return TieredBackend(
            SegmentBackend(str(tmp_path / "cold"), segment_bytes=8 << 10),
            hot_bytes=16 << 10)
    raise ConfigError(name)


def chunks(rng, n=24, size=400):
    return [encode_chunk(3, rng.bytes(size) + bytes([i])) for i in range(n)]


all_backends = pytest.mark.parametrize("backend", BACKENDS, indirect=True)


@all_backends
def test_satisfies_protocol(backend):
    assert isinstance(backend, StorageBackend)


@all_backends
def test_put_get_roundtrip_singular(backend, rng):
    raw = encode_chunk(3, rng.bytes(1000))
    cid = backend.put(raw)
    assert cid == cid_of(raw)
    assert backend.get(cid) == raw
    assert backend.has(cid)


@all_backends
def test_batched_roundtrip_preserves_order(backend, rng):
    raws = chunks(rng)
    cids = backend.put_many(raws)
    assert cids == [cid_of(r) for r in raws]
    assert backend.get_many(cids) == raws
    assert backend.get_many(list(reversed(cids))) == list(reversed(raws))
    assert all(backend.has_many(cids))


@all_backends
def test_explicit_cids_accepted(backend, rng):
    raws = chunks(rng, n=5)
    pre = [cid_of(r) for r in raws]
    assert backend.put_many(raws, pre) == pre
    assert backend.get_many(pre) == raws


@all_backends
def test_missing_chunk_raises(backend, rng):
    backend.put_many(chunks(rng, n=3))
    ghost = bytes(32)
    assert backend.has_many([ghost]) == [False]
    with pytest.raises(KeyError):        # ChunkMissing subclasses KeyError
        backend.get(ghost)


@all_backends
def test_dedup_on_put(backend, rng):
    raw = encode_chunk(3, rng.bytes(2000))
    backend.put(raw)
    phys = backend.stats.physical_bytes
    backend.put(raw)
    backend.put_many([raw, raw])
    st = backend.stats
    assert st.physical_bytes == phys          # stored once (k copies max)
    assert st.dedup_hits >= 3
    assert st.logical_bytes == 4 * len(raw)
    k = getattr(backend, "k", 1)              # replication is physical
    assert st.dedup_ratio > 3.9 / k


@all_backends
def test_len_counts_distinct_chunks(backend, rng):
    raws = chunks(rng, n=10)
    backend.put_many(raws + raws[:4])
    assert len(backend) == 10


@all_backends
def test_stats_count_batches(backend, rng):
    raws = chunks(rng, n=16)
    cids = backend.put_many(raws)
    backend.get_many(cids)
    st = backend.stats
    assert st.puts == 16 and st.put_batches == 1
    assert st.gets == 16 and st.get_batches == 1


@all_backends
def test_flush_is_safe(backend, rng):
    cid = backend.put(encode_chunk(3, rng.bytes(100)))
    backend.flush()
    assert backend.get(cid)


# --------------------------------------------------------- delete (GC sweep)

@all_backends
def test_delete_many_removes_everywhere(backend, rng):
    raws = chunks(rng, n=12)
    cids = backend.put_many(raws)
    phys = _physical_bytes(backend)
    assert backend.delete_many(cids[:5]) == 5
    assert backend.has_many(cids) == [False] * 5 + [True] * 7
    with pytest.raises(KeyError):
        backend.get(cids[0])
    assert len(backend) == 7
    st = backend.stats
    assert st.deletes == 5
    assert st.reclaimed_bytes > 0
    assert 0 <= _physical_bytes(backend) < phys
    assert backend.get_many(cids[5:]) == raws[5:]   # survivors intact


@all_backends
def test_delete_missing_is_noop(backend, rng):
    cid = backend.put(encode_chunk(3, rng.bytes(64)))
    assert backend.delete_many([bytes(32)]) == 0
    assert backend.stats.deletes == 0
    assert backend.get(cid)


@all_backends
def test_reput_after_delete(backend, rng):
    raw = encode_chunk(3, rng.bytes(500))
    cid = backend.put(raw)
    backend.delete(cid)
    d0 = backend.stats.dedup_hits
    assert backend.put(raw) == cid                  # fresh put, not dedup
    assert backend.stats.dedup_hits == d0
    assert backend.get(cid) == raw


@all_backends
def test_iter_cids_is_sweep_inventory(backend, rng):
    raws = chunks(rng, n=9)
    cids = backend.put_many(raws)
    assert _inventory(backend) == set(cids)
    backend.delete_many(cids[:4])
    assert _inventory(backend) == set(cids[4:])


def _inventory(backend):
    """Cluster-wide sweep inventory.  A routing store's ``iter_cids``
    is scoped to its OWN servlet's share (lazy, per-node) — the full
    inventory is the union across servlets, and the shares must be
    disjoint (each chunk swept exactly once in a cluster-wide walk)."""
    cl = getattr(backend, "cluster", None)
    if cl is None:
        return set(backend.iter_cids())
    shares = [set(n.servlet.store.iter_cids()) for n in cl.nodes]
    union: set = set()
    for s in shares:
        assert not (union & s), "servlet inventories must be disjoint"
        union |= s
    return union


def _physical_bytes(backend):
    """Physical truth for a stack: cluster routing stores are write-side
    views, so sum the node stores instead."""
    cl = getattr(backend, "cluster", None)
    if cl is not None:
        return sum(n.store.stats.physical_bytes for n in cl.nodes)
    return backend.stats.physical_bytes


@all_backends
def test_gc_collects_removed_branch_through_stack(backend, rng):
    """Acceptance: two branches, remove one, collect; the store shrinks
    and the surviving head reads back byte-identical — through every
    backend stack (memory/log/LRU/replicated/sharded/cluster routing)."""
    db = ForkBase(backend)
    keep = rng.bytes(60_000)
    db.put("k", FBlob(keep))
    db.fork("k", "master", "scratch")
    db.put("k", FBlob(rng.bytes(60_000)), "scratch")
    n0 = len(backend)
    phys0 = _physical_bytes(backend)
    db.remove("k", "scratch")
    report = db.gc()
    assert report.swept_chunks > 0
    assert len(backend) < n0
    assert 0 <= _physical_bytes(backend) < phys0
    assert db.get("k").blob().read() == keep
    # idempotent: a second collect sweeps nothing
    assert db.gc().swept_chunks == 0


@pytest.mark.parametrize("backend", ["replicated"], indirect=True)
def test_delete_removes_all_replicas(backend, rng):
    raw = encode_chunk(3, rng.bytes(900))
    cid = backend.put(raw)
    assert sum(1 for s in backend.stores if s.has(cid)) == backend.k
    assert backend.delete(cid) == 1
    assert not any(s.has(cid) for s in backend.stores)
    assert backend.stats.deletes == 1               # counted once, not k


@pytest.mark.parametrize("backend", ["lru"], indirect=True)
def test_delete_invalidates_cache(backend, rng):
    cid = backend.put(encode_chunk(3, rng.bytes(700)))
    backend.get(cid)                                # hot in cache
    backend.delete(cid)
    assert not backend.has(cid)
    with pytest.raises(ChunkMissing):
        backend.get(cid)                            # not served from LRU


@pytest.mark.parametrize("backend", ["routing"], indirect=True)
def test_cluster_delete_updates_index_and_node_stats(backend, rng):
    cl = backend.cluster
    cids = backend.put_many(chunks(rng, n=40))
    bytes0 = sum(n.stats.chunk_bytes for n in cl.nodes)
    backend.delete_many(cids[:15])
    assert all(c not in cl.index for c in cids[:15])
    assert sum(n.stats.chunks for n in cl.nodes) == 25
    assert sum(n.stats.chunk_bytes for n in cl.nodes) < bytes0


def test_write_buffer_delete_counts_pending_and_inner_once(rng):
    """A cid both pending and already stored inner is ONE logical chunk."""
    inner = MemoryBackend()
    raw = encode_chunk(3, rng.bytes(200))
    cid = inner.put(raw)
    buf = WriteBuffer(inner)
    buf.put(raw)                                    # pending duplicate
    assert buf.delete_many([cid, cid]) == 1
    assert not inner.has(cid) and not buf.has(cid)


def test_write_buffer_delete_retracts_pending(rng):
    inner = MemoryBackend()
    buf = WriteBuffer(inner)
    raws = chunks(rng, n=4)
    cids = buf.put_many(raws)
    buf.delete_many(cids[:2])                       # never reach the store
    assert buf.has_many(cids) == [False, False, True, True]
    buf.flush()
    assert len(inner) == 2
    assert inner.get_many(cids[2:]) == raws[2:]
    # closed buffer: transparent pass-through
    assert buf.delete_many([cids[2]]) == 1
    assert not inner.has(cids[2])


# ------------------------------------------------------- put listeners

@all_backends
def test_put_listener_fires_with_batch_cids(backend, rng):
    """Conformance: every backend notifies put listeners with the batch
    cids — dedup acks included (re-referencing an existing chunk must
    still reach an in-flight collection's barrier)."""
    heard = []
    backend.add_put_listener(heard.append)
    raws = chunks(rng, n=5)
    cids = backend.put_many(raws)
    assert heard and heard[-1] == cids
    n0 = len(heard)
    backend.put_many(raws)                          # pure dedup batch
    assert len(heard) > n0 and heard[-1] == cids
    backend.remove_put_listener(heard.append)
    backend.put(encode_chunk(3, rng.bytes(64)))
    assert heard[-1] == cids                        # detached: silent


class _SpyLock:
    """A context-manager lock that records whether it is held."""

    def __init__(self):
        self.held = False
        self.entered = 0

    def __enter__(self):
        self.held = True
        self.entered += 1
        return self

    def __exit__(self, *exc):
        self.held = False


@all_backends
def test_put_many_holds_the_parked_barrier_lock(backend, rng):
    """While a collection parks its lock on a store, one put batch —
    store write and barrier notification — runs inside it; with none
    parked the put takes no lock."""
    assert backend._barrier_lock is None
    lk = _SpyLock()
    heard = []
    backend.add_put_listener(lambda cids: heard.append(lk.held))
    backend._barrier_lock = lk
    backend.put_many(chunks(rng, n=3))
    assert lk.entered == 1 and heard == [True] and not lk.held
    backend._barrier_lock = None
    backend.put_many(chunks(rng, n=3))
    assert lk.entered == 1 and heard == [True, False]


@all_backends
def test_put_mid_mark_is_shaded_and_survives(backend, rng):
    """A put landing mid-mark must gray its refs on every backend stack:
    the new version survives the epoch even though it was not in the
    root snapshot."""
    from repro_torch.gc import GCPhase
    db = ForkBase(backend)
    keep = rng.bytes(60_000)
    db.put("k1", FBlob(keep))
    db.fork("k1", "master", "tmp")
    db.put("k1", FBlob(rng.bytes(60_000)), "tmp")
    db.remove("k1", "tmp")                          # garbage to collect
    col = db.incremental_gc()
    assert col.step(2) is GCPhase.MARK              # mark in flight
    fresh = rng.bytes(60_000)
    uid = db.put("k2", FBlob(fresh))                # put landing mid-mark
    assert uid in col.marked                        # barrier grayed it
    while col.step(16) is not GCPhase.DONE:
        pass
    assert col.report.swept_chunks > 0
    assert col.report.barriered > 0
    assert db.get("k1").blob().read() == keep
    assert db.get("k2").blob().read() == fresh


@all_backends
def test_dedup_put_mid_sweep_rescues_condemned_chunks(backend, rng):
    """A put landing mid-sweep that dedups against condemned chunks must
    rescue them before their slice is deleted — on every stack."""
    from repro_torch.gc import GCPhase
    db = ForkBase(backend)
    data = rng.bytes(60_000)
    db.put("k", FBlob(data), "tmp")
    db.remove("k", "tmp")                           # whole value condemned
    col = db.incremental_gc()
    while col.step(4) is GCPhase.MARK:
        pass
    assert col.phase is GCPhase.SWEEP               # frozen, nothing swept
    uid = db.put("k", FBlob(data))                  # dedups against condemned
    assert col.report.barriered > 0                 # rescued, not resurrected
    while col.step(4) is not GCPhase.DONE:
        pass
    assert db.get("k", uid=uid).blob().read() == data


# --------------------------------------------------- log: tombstones, compact

def test_log_tombstones_survive_reopen(tmp_path, rng):
    path = str(tmp_path / "chunks.log")
    be = MemoryBackend(log_path=path)
    cids = be.put_many(chunks(rng, n=6))
    be.delete_many(cids[:3])
    be.flush()
    # replay WITHOUT compaction: deletes must not resurrect
    be2 = MemoryBackend(log_path=path)
    assert be2.has_many(cids) == [False] * 3 + [True] * 3
    assert len(be2) == 3


def test_compact_log_shrinks_and_preserves(tmp_path, rng):
    path = str(tmp_path / "chunks.log")
    be = MemoryBackend(log_path=path)
    raws = chunks(rng, n=10, size=800)
    cids = be.put_many(raws)
    be.delete_many(cids[:7])
    before, after = be.compact_log()
    assert after < before
    assert be.log_size() == after
    # compacted log replays to exactly the live set
    be2 = MemoryBackend(log_path=path, verify=True)
    assert len(be2) == 3
    assert be2.get_many(cids[7:]) == raws[7:]
    assert be2.stats.physical_bytes == be.stats.physical_bytes
    # backend stays writable after compaction (handle reopened)
    extra = be.put(encode_chunk(3, rng.bytes(128)))
    be.flush()
    assert MemoryBackend(log_path=path).has(extra)


def test_torn_tail_truncated_so_postcrash_writes_survive(tmp_path, rng):
    """Recovery must truncate the torn record on disk: records appended
    after it (tombstones, new chunks) would otherwise be parsed as the
    torn record's payload on the next replay and silently lost."""
    path = str(tmp_path / "chunks.log")
    be = MemoryBackend(log_path=path)
    cids = be.put_many(chunks(rng, n=3))
    be.flush()
    with open(path, "r+b") as f:        # crash mid-append: torn record
        f.seek(0, 2)
        f.write(b"\x03torn-partial-record")
    be2 = MemoryBackend(log_path=path)  # recovers prefix, truncates tail
    assert len(be2) == 3
    be2.delete_many(cids[:1])           # post-crash tombstone
    extra = be2.put(encode_chunk(3, rng.bytes(99)))
    be2.flush()
    be3 = MemoryBackend(log_path=path)
    assert not be3.has(cids[0])         # tombstone replayed, not eaten
    assert be3.has(extra)               # post-crash put survived
    assert be3.get_many(cids[1:]) == be2.get_many(cids[1:])


def test_compact_without_log_is_noop():
    assert MemoryBackend().compact_log() == (0, 0)


_REPLAY_STATS = ("puts", "logical_bytes", "physical_bytes", "deletes",
                 "reclaimed_bytes", "dedup_hits")


def _replay_stats(be):
    return {f: getattr(be.stats, f) for f in _REPLAY_STATS}


def test_replay_restores_stats(tmp_path, rng):
    """For a workload the log fully records (unique chunks + deletes, no
    compaction) the replay-recoverable stats must survive a reopen
    exactly."""
    path = str(tmp_path / "chunks.log")
    be = MemoryBackend(log_path=path)
    raws = chunks(rng, n=8, size=600)
    cids = be.put_many(raws)
    be.delete_many(cids[:3])
    be.flush()
    want = _replay_stats(be)
    assert want["puts"] == 8 and want["deletes"] == 3
    assert want["logical_bytes"] == sum(len(r) for r in raws)
    be2 = MemoryBackend(log_path=path)
    assert _replay_stats(be2) == want
    assert be2.stats.dedup_ratio == be.stats.dedup_ratio
    # delete + re-put leaves three records; replay must net them out
    be2.delete_many(cids[3:4])
    be2.put(raws[3])
    be2.flush()
    be3 = MemoryBackend(log_path=path)
    assert be3.stats.physical_bytes == be2.stats.physical_bytes
    assert be3.stats.deletes == 4 and be3.stats.puts == 9
    assert sorted(be3.iter_cids()) == sorted(be2.iter_cids())


def _replay_ops(rng):
    """One random interleaving of put/delete/compact/reopen (what the
    reference draws with hypothesis)."""
    kinds = ("put", "delete", "compact", "reopen")
    return [(kinds[int(rng.integers(4))], int(rng.integers(0, 12)))
            for _ in range(int(rng.integers(1, 41)))]


def test_replay_stats_match_fresh_reexecution(tmp_path):
    """Under random put/delete/compact/reopen interleavings, a reopened
    backend converges to the identical ``_data`` AND identical stats of a
    fresh backend that executes exactly the log's surviving operations —
    i.e. replay is semantically a re-execution, not just a data load.

    The reference's copy names the per-put flag ``fresh``, which shadows
    its unique-path counter inside the property and makes the first
    ``next(fresh)`` raise UnboundLocalError; here the flag is ``is_new``,
    so the property runs as meant.  40 seeded examples stand in for the
    reference's 40 hypothesis examples."""
    fresh = itertools.count()          # unique log path per example
    for example in range(40):
        rng = np.random.default_rng(1000 + example)
        ops_ = _replay_ops(rng)
        pool = chunks(rng, n=12, size=200)
        path = str(tmp_path / f"prop-{next(fresh)}.log")
        be = MemoryBackend(log_path=path)
        # the model: what a fresh store replaying the CURRENT log would
        # count — compaction rewrites the log to the live set only
        model = {f: 0 for f in _REPLAY_STATS}
        for op, i in ops_:
            if op == "put":
                raw = pool[i]
                cid = cid_of(raw)
                is_new = not be.has(cid)
                be.put(raw)
                if is_new:           # dedup acks are not logged
                    model["puts"] += 1
                    model["logical_bytes"] += len(raw)
                    model["physical_bytes"] += len(raw)
            elif op == "delete":
                cid = cid_of(pool[i])
                if be.has(cid):
                    be.delete(cid)
                    model["deletes"] += 1
                    model["reclaimed_bytes"] += len(pool[i])
                    model["physical_bytes"] -= len(pool[i])
            elif op == "compact":
                be.compact_log()     # history drops out of the log
                live = sum(len(r) for r in be._data.values())
                model = {f: 0 for f in _REPLAY_STATS}
                model["puts"] = len(be._data)
                model["logical_bytes"] = live
                model["physical_bytes"] = live
            else:
                be.flush()
                data_before = dict(be._data)
                be = MemoryBackend(log_path=path)
                assert be._data == data_before      # identical _data
                assert _replay_stats(be) == model   # identical stats
        be.flush()
        be2 = MemoryBackend(log_path=path)
        assert be2._data == be._data
        assert _replay_stats(be2) == model


# ----------------------------------------------------- tamper detection

@pytest.fixture
def verified_backend(request, tmp_path):
    """The same eight stacks, with integrity verification enabled in
    every leaf store (and on the cluster nodes)."""
    name = request.param
    vmem = lambda: MemoryBackend(verify=True)  # noqa: E731
    if name == "memory":
        return vmem()
    if name == "log":
        return MemoryBackend(log_path=str(tmp_path / "chunks.log"),
                             verify=True)
    if name == "lru":
        return LRUCacheBackend(vmem(), capacity_bytes=1 << 20, verify=True)
    if name == "replicated":
        return ReplicatedBackend([vmem() for _ in range(3)], k=2)
    if name == "sharded":
        return ShardedBackend(4, factory=vmem)
    if name == "routing":
        return Cluster(3, verify=True).nodes[0].servlet.store
    if name == "segment":
        return SegmentBackend(str(tmp_path / "segs"),
                              segment_bytes=8 << 10, verify=True)
    if name == "tiered":
        return TieredBackend(
            SegmentBackend(str(tmp_path / "cold"), segment_bytes=8 << 10,
                           verify=True),
            hot_bytes=16 << 10, verify=True)
    raise ConfigError(name)


def _leaf_stores(backend):
    """Every leaf store (MemoryBackend / SegmentBackend) a stack bottoms
    out in."""
    if isinstance(backend, (MemoryBackend, SegmentBackend)):
        return [backend]
    if isinstance(backend, LRUCacheBackend):
        return _leaf_stores(backend.inner)
    if isinstance(backend, TieredBackend):
        return _leaf_stores(backend.cold)
    if isinstance(backend, ReplicatedBackend):
        return [leaf for s in backend.stores for leaf in _leaf_stores(s)]
    if isinstance(backend, ShardedBackend):
        return [leaf for s in backend.shards for leaf in _leaf_stores(s)]
    cluster = getattr(backend, "cluster", None)
    if cluster is not None:
        return [leaf for n in cluster.nodes for leaf in _leaf_stores(n.store)]
    raise ConfigError(type(backend).__name__)


def _flip_leaf(leaf, cid) -> int:
    """Flip one byte of ``cid``'s raw inside one leaf store (in the dict
    for MemoryBackend, ON DISK for SegmentBackend)."""
    if isinstance(leaf, MemoryBackend):
        raw = leaf._data.get(cid)
        if raw is None:
            return 0
        leaf._data[cid] = raw[:-1] + bytes([raw[-1] ^ 0x55])
        return 1
    gen = leaf._index.get(cid)
    if gen is None:
        return 0
    leaf.flush()                        # the record must be on disk to flip
    seg = leaf._segments[gen]
    off, ln = seg.live[cid]
    with open(seg.path, "r+b") as f:
        f.seek(off + ln - 1)
        last = f.read(1)[0]
        f.seek(off + ln - 1)
        f.write(bytes([last ^ 0x55]))
    return 1


def _corrupt_everywhere(backend, cid):
    """Flip one byte in EVERY materialization of ``cid`` — all replicas,
    the owning shard/node, any resident cache copy, AND the hot-tier
    copy (a cache/hot tier must not be a verification hole)."""
    hit = 0
    for leaf in _leaf_stores(backend):
        hit += _flip_leaf(leaf, cid)
    if isinstance(backend, LRUCacheBackend):
        raw = backend._cache.get(cid)
        if raw is not None:
            backend._cache[cid] = raw[:-1] + bytes([raw[-1] ^ 0x55])
            hit += 1
    if isinstance(backend, TieredBackend):
        raw = backend._hot.get(cid)
        if raw is not None:
            backend._hot[cid] = raw[:-1] + bytes([raw[-1] ^ 0x55])
            hit += 1
    assert hit > 0
    return hit


def _stack_stat(be, name):
    leaves = _leaf_stores(be)
    total = sum(getattr(leaf.stats, name) for leaf in leaves)
    if all(leaf is not be for leaf in leaves):
        total += getattr(be.stats, name)        # cache/tier-layer checks
    return total


@pytest.mark.parametrize("verified_backend", BACKENDS, indirect=True)
def test_corruption_surfaces_tampered_chunk(verified_backend, rng):
    """Conformance: a flipped byte in a stored raw surfaces TamperedChunk
    from get/get_many on every backend stack — corruption can never be
    silently returned to a reader."""
    be = verified_backend
    raws = chunks(rng, n=8)
    cids = be.put_many(raws)
    assert be.get_many(cids) == raws
    assert _stack_stat(be, "verifies") > 0      # reads actually verified
    _corrupt_everywhere(be, cids[2])
    with pytest.raises(TamperedChunk):
        be.get_many(cids)
    with pytest.raises(TamperedChunk):
        be.get(cids[2])
    assert _stack_stat(be, "verify_failures") >= 1
    # untouched chunks still read clean
    ok = [c for i, c in enumerate(cids) if i != 2]
    assert be.get_many(ok) == [r for i, r in enumerate(raws) if i != 2]


@pytest.mark.parametrize("verified_backend", BACKENDS, indirect=True)
def test_verified_stack_roundtrip_counts_verifies(verified_backend, rng):
    """StoreStats.verifies ticks on the verify-enabled read path and no
    failures are recorded for clean data."""
    be = verified_backend
    cids = be.put_many(chunks(rng, n=5))
    be.get_many(cids)
    assert _stack_stat(be, "verifies") >= 5
    assert _stack_stat(be, "verify_failures") == 0


@pytest.mark.parametrize("verified_backend", ["segment", "tiered"],
                         indirect=True)
def test_verified_durable_stack_rejects_a_wrong_caller_cid(verified_backend,
                                                           rng):
    """The durable stores verify caller-supplied cids on put (the tiered
    store at the top, the segment store again on demotion)."""
    raw = encode_chunk(3, rng.bytes(100))
    with pytest.raises(TamperedChunk):
        verified_backend.put(raw, cid=bytes(32))
    assert _stack_stat(verified_backend, "verify_failures") == 1
    assert not verified_backend.has(bytes(32))


def test_replay_detects_tampering(tmp_path, rng):
    path = str(tmp_path / "chunks.log")
    be = MemoryBackend(log_path=path)
    raw = encode_chunk(3, rng.bytes(300))
    be.put(raw)
    be.flush()
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    with pytest.raises(TamperedChunk):
        MemoryBackend(log_path=path, verify=True)
    # without verify the tamper goes through (documented trade-off)
    assert len(MemoryBackend(log_path=path)) == 1


def test_segment_replay_detects_tampering(tmp_path, rng):
    """The segment store's record scan of its active segment verifies
    like the log replay."""
    root = str(tmp_path / "segs")
    be = SegmentBackend(root)
    be.put(encode_chunk(3, rng.bytes(300)))
    be.close()
    path = str(tmp_path / "segs" / "seg-00000001.seg")
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    with pytest.raises(TamperedChunk):
        SegmentBackend(root, verify=True)
    assert len(SegmentBackend(root)) == 1


def test_put_get_tamper_checks_are_typed(rng):
    be = MemoryBackend(verify=True)
    raw = encode_chunk(3, rng.bytes(100))
    with pytest.raises(TamperedChunk):
        be.put(raw, cid=bytes(32))                  # wrong caller cid
    cid = be.put(raw)
    be._data[cid] = raw[:-1] + bytes([raw[-1] ^ 1])
    with pytest.raises(TamperedChunk):
        be.get(cid)


# ------------------------------------------------- batched chunk checks

# each site of the durable stores that checks a batch, and the ``where``
# of its TamperedChunk: the memory tier's hits, a read out of sealed
# segments (their maps) and out of the active one (``pread``), and the
# checks of caller cids on put
BATCH_SITES = {"hot": "hot-tier hit", "sealed": "Get-Chunk",
               "active": "Get-Chunk", "tiered.put": "Put-Chunk",
               "segment.put": "Put-Chunk"}


def _checked_batch(site, root, raws, ks):
    """A verifying store and the call that checks ``raws`` as one batch,
    with the chunks at ``ks`` altered where the site reads them: (store
    whose stats count the checks, call)."""
    cids = [cid_of(r) for r in raws]
    seg = SegmentBackend(root, verify=True,
                         segment_bytes=1 if site == "sealed" else 1 << 30)
    store = (TieredBackend(seg, verify=True)
             if site in ("hot", "tiered.put") else seg)
    batch = list(raws)
    for k in ks:
        batch[k] = raws[k][:-1] + bytes([raws[k][-1] ^ 0x55])
    if site.endswith(".put"):
        return store, lambda: store.put_many(batch, cids)
    store.put_many(raws)
    for k in ks:
        if site == "hot":
            store._hot[cids[k]] = batch[k]
        else:
            _flip_leaf(store, cids[k])
            assert seg._segments[seg._index[cids[k]]].sealed == (
                site == "sealed")
    return store, lambda: store.get_many(cids)


@pytest.mark.parametrize("pos", ["first", "middle", "last", "first+last",
                                 "none"])
@pytest.mark.parametrize("n", [2, 7, 64])
@pytest.mark.parametrize("site", list(BATCH_SITES))
def test_a_batch_check_fails_and_counts_as_the_chunk_loop(tmp_path, rng,
                                                          site, n, pos):
    """A batch with an altered chunk raises TamperedChunk for the first
    altered cid, with the site's ``where``; ``verifies`` grows by the
    chunks up to and including it and ``verify_failures`` by one, as
    checking chunk by chunk counts; a clean batch counts every chunk.  A
    batch of at least ``CHECK_BATCH_MIN`` chunks is one batched check."""
    from repro_torch.storage.backend import CHECK_BATCH_MIN
    raws = chunks(rng, n=n, size=200)
    ks = {"first": [0], "middle": [n // 2], "last": [n - 1],
          "first+last": [0, n - 1], "none": []}[pos]
    store, call = _checked_batch(site, str(tmp_path / "s"), raws, ks)
    st = store.stats
    v0, f0, b0 = st.verifies, st.verify_failures, st.verify_batches
    if not ks:
        got = call()
        assert got == [cid_of(r) for r in raws] if site.endswith(".put") \
            else got == raws
        assert (st.verifies - v0, st.verify_failures - f0) == (n, 0)
    else:
        with pytest.raises(TamperedChunk) as err:
            call()
        assert err.value.cid == cid_of(raws[ks[0]])
        assert err.value.where == BATCH_SITES[site]
        assert (st.verifies - v0, st.verify_failures - f0) == (ks[0] + 1, 1)
    assert st.verify_batches - b0 == (n >= CHECK_BATCH_MIN)


@pytest.mark.parametrize("first", ["altered", "missing"])
def test_a_segment_batch_fails_at_its_first_bad_or_missing_chunk(
        tmp_path, rng, first):
    """A read batch with an altered chunk and a missing one raises for
    whichever comes first, as a read checking each chunk as it copies it
    out would; checks count the chunks read before the failure."""
    from repro_torch.storage import ChunkMissing
    raws = chunks(rng, n=6, size=200)
    store, _ = _checked_batch("sealed", str(tmp_path / "s"), raws, [3])
    cids = [cid_of(r) for r in raws]
    cids.insert(2 if first == "missing" else 5, bytes(32))
    v0 = store.stats.verifies
    with pytest.raises(TamperedChunk if first == "altered" else ChunkMissing):
        store.get_many(cids)
    assert store.stats.verifies - v0 == (4 if first == "altered" else 2)
    assert store.stats.verify_failures == (first == "altered")


# ------------------------------------------------------- batched pipeline

@pytest.mark.parametrize("backend", ["memory"], indirect=True)
def test_value_commits_in_one_batch(backend, rng):
    """Acceptance: N-chunk value -> one put_many (batch calls << chunks)."""
    db = ForkBase(backend)
    db.put("blob", FBlob(rng.bytes(300_000)))
    st = backend.stats
    assert st.put_batches == 1
    assert st.puts > 20 * st.put_batches
    db.put("map", FMap({b"k%04d" % i: rng.bytes(64) for i in range(3000)}))
    assert st.put_batches == 2
    assert st.puts > 20 * st.put_batches


@pytest.mark.parametrize("backend", ["memory"], indirect=True)
def test_write_buffer_nests_and_passes_through(backend, rng):
    outer = WriteBuffer(backend)
    inner = WriteBuffer(outer)
    raws = chunks(rng, n=6)
    cids = inner.put_many(raws)
    assert inner.get_many(cids) == raws       # reads see pending chunks
    assert len(backend) == 0
    inner.flush()
    assert len(backend) == 0                  # still buffered in outer
    outer.flush()
    assert backend.stats.put_batches == 1     # ONE real store round-trip
    assert backend.get_many(cids) == raws
    # closed buffers are transparent: writes land directly in the store
    extra = inner.put(encode_chunk(3, rng.bytes(50)))
    assert backend.has(extra)


@pytest.mark.parametrize("backend", ["lru"], indirect=True)
def test_lru_serves_repeat_reads_from_cache(backend, rng):
    cids = backend.put_many(chunks(rng, n=8))
    backend.inner.stats.gets = 0
    backend.get_many(cids)
    backend.get_many(cids)
    assert backend.inner.stats.gets == 0      # write-through populated it
    assert backend.stats.cache_hits == 16


@pytest.mark.parametrize("backend", ["replicated"], indirect=True)
def test_replicated_reads_stay_batched(backend, rng):
    """get_many groups by primary replica: O(replicas) inner batches,
    not one batch-of-one per cid."""
    raws = chunks(rng, n=30)
    cids = backend.put_many(raws)
    g0 = sum(s.stats.get_batches for s in backend.stores)
    assert backend.get_many(cids) == raws
    assert sum(s.stats.get_batches for s in backend.stores) - g0 <= \
        len(backend.stores)


@pytest.mark.parametrize("backend", ["replicated"], indirect=True)
def test_replication_factor_and_failover(backend, rng):
    raw = encode_chunk(3, rng.bytes(1500))
    cid = backend.put(raw)
    assert sum(1 for s in backend.stores if s.has(cid)) == backend.k
    for s in backend.stores:                  # kill the primary replica
        if s.has(cid):
            del s._data[cid]
            break
    assert backend.get(cid) == raw            # failover to the other copy
    with pytest.raises(ChunkMissing):
        backend.get_many([bytes(32)])


@pytest.mark.parametrize("backend", ["replicated"], indirect=True)
def test_replicated_audit_waits_for_the_proof_slice(backend, rng):
    """The proof slice has landed: the replica audit runs, is clean on
    intact copies and names the replica holding a corrupted one."""
    cid = backend.put(encode_chunk(3, rng.bytes(1500)))
    assert backend.audit(sample=10_000).ok
    victim = next(i for i, s in enumerate(backend.stores) if s.has(cid))
    raw = backend.stores[victim]._data[cid]
    backend.stores[victim]._data[cid] = raw[:-1] + bytes([raw[-1] ^ 0xFF])
    rep = backend.audit(sample=10_000)
    assert [(f.node, f.kind, f.cid) for f in rep.findings] == \
        [(f"replica{victim}", "corrupt", cid)]


@pytest.mark.parametrize("backend", ["sharded"], indirect=True)
def test_sharding_spreads_chunks(backend, rng):
    backend.put_many(chunks(rng, n=200))
    dist = [len(s) for s in backend.shards]
    assert sum(dist) == 200
    assert min(dist) > 0                      # cid hash spreads uniformly
    assert sum(backend.distribution()) == backend.stats.physical_bytes


@pytest.mark.parametrize("backend", ["memory"], indirect=True)
def test_make_backend_specs(backend, tmp_path, rng):
    for spec, kw in [("memory", {}), ("lru+memory", {}),
                     ("lru+sharded", {"shards": 2}),
                     ("replicated", {"n": 3, "k": 2}),
                     ("log", {"log_path": str(tmp_path / "l.log")}),
                     ("segment", {"root": str(tmp_path / "segs")}),
                     ("tiered", {"root": str(tmp_path / "tier")})]:
        b = make_backend(spec, **kw)
        raw = encode_chunk(3, rng.bytes(128))
        assert b.get(b.put(raw)) == raw
    with pytest.raises(ValueError):
        make_backend("bogus")


@pytest.mark.parametrize("backend", ["memory"], indirect=True)
def test_fphash_many_matches_per_chunk_kernel(backend, rng):
    """The batched fphash entry point equals the singular one per chunk,
    and both equal the JAX package's fphash."""
    from repro.kernels.fphash import fphash as ref_fphash
    blobs = [rng.bytes(n) for n in (0, 1, 300, 4096, 4097, 9000)]
    many = ops.content_hash_many(blobs)
    assert many == [ops.content_hash(b) for b in blobs]
    assert many == [ref_fphash(b) for b in blobs]


@pytest.mark.parametrize("backend", ["memory"], indirect=True)
def test_fphash_dispatch_roundtrip(backend, rng):
    """use_fphash(): cids route through the batched fphash entry point;
    the engine works identically (one batch per value commit)."""
    from repro_torch.core import hashing
    hashing.use_fphash()
    try:
        db = ForkBase(backend)
        data = rng.bytes(50_000)
        db.put("k", FBlob(data))
        assert db.get("k").blob().read() == data
        assert backend.stats.put_batches == 1
    finally:
        hashing.use_sha256()
