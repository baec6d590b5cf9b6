"""Durable tiered storage of the port (repro_torch.storage.durable), on
the CPU: crash recovery, restart, tiering policy and compaction — the
JAX package's ``tests/test_durable.py``, less the tests that need the GC,
cluster and checkpoint slices of the port (the GC report's compacted
bytes, the durable cluster restart, the durable checkpoint restart).

The reopen-after-kill family runs against BOTH append-only on-disk
stores — ``MemoryBackend(log_path=...)`` and ``SegmentBackend`` — since
they share the record framing and the torn-tail recovery contract:
anything acknowledged by ``flush()`` survives; a torn tail is truncated
so post-crash appends land at a parseable offset.
"""
import os

import numpy as np
import pytest

from repro_torch.core import ForkBase, FMap
from repro_torch.core.branch import BranchTable
from repro_torch.core.chunk import cid_of, encode_chunk
from repro_torch.kernels import ops
from repro_torch.storage import (MemoryBackend, SegmentBackend,
                                 TieredBackend, WriteBuffer, open_durable)
from repro_torch.storage.durable.segment import _LEN, _TOMBSTONE


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def chunks(rng, n=8, size=300):
    return [encode_chunk(3, rng.bytes(size) + bytes([i])) for i in range(n)]


# ------------------------------------------------- reopen-after-kill family

@pytest.fixture(params=["log", "segment"])
def reopenable(request, tmp_path):
    """(make, datafile): a factory reopening the same on-disk store, and
    the file a crash would tear (the log / the active segment)."""
    if request.param == "log":
        path = str(tmp_path / "chunks.log")

        def make():
            return MemoryBackend(log_path=path)

        def datafile():
            return path
    else:
        root = str(tmp_path / "segs")

        def make():
            # one active segment, no auto compaction: the pure
            # record-scan recovery path
            return SegmentBackend(root, segment_bytes=1 << 30,
                                  auto_compact=False)

        def datafile():
            segs = sorted(f for f in os.listdir(root)
                          if f.startswith("seg-") and f.endswith(".seg"))
            return os.path.join(root, segs[-1])
    return make, datafile


def test_torn_tail_mid_record_recovers_prefix(reopenable, rng):
    make, datafile = reopenable
    be = make()
    raws = chunks(rng, n=5)
    cids = be.put_many(raws)
    be.flush()
    with open(datafile(), "ab") as f:       # crash mid-append: the cid
        f.write(bytes(32) + _LEN.pack(1000) + b"partial-payload")
    be2 = make()                            # and length landed, payload torn
    assert sorted(be2.iter_cids()) == sorted(cids)
    assert be2.get_many(cids) == raws
    # the tail was truncated ON DISK: post-crash appends stay parseable
    be2.delete_many(cids[:1])
    extra = be2.put(encode_chunk(3, rng.bytes(90)))
    be2.flush()
    be3 = make()
    assert not be3.has(cids[0])
    assert be3.has(extra)
    assert be3.get_many(cids[1:]) == raws[1:]


def test_torn_tail_mid_tombstone_recovers_prefix(reopenable, rng):
    make, datafile = reopenable
    be = make()
    raws = chunks(rng, n=4)
    cids = be.put_many(raws)
    be.flush()
    # crash mid-tombstone append: cid + 2 of the 4 length bytes
    with open(datafile(), "ab") as f:
        f.write(cids[1] + _LEN.pack(_TOMBSTONE)[:2])
    be2 = make()
    assert be2.has(cids[1])                 # torn tombstone NOT applied
    assert be2.get_many(cids) == raws
    be2.delete_many(cids[1:2])              # the delete redone post-crash
    be2.flush()
    be3 = make()
    assert not be3.has(cids[1])
    assert be3.get_many([cids[0]] + cids[2:]) == [raws[0]] + raws[2:]


def test_crash_between_sweep_and_compaction(reopenable, rng):
    """The GC sweep flushes its tombstones before compaction runs; a
    crash in that window must neither resurrect swept chunks nor lose
    survivors."""
    make, _ = reopenable
    be = make()
    raws = chunks(rng, n=8)
    cids = be.put_many(raws)
    be.delete_many(cids[:5])                # the sweep
    be.flush()                              # durable tombstones...
    be2 = make()                            # ...crash before compaction
    assert be2.has_many(cids) == [False] * 5 + [True] * 3
    assert be2.get_many(cids[5:]) == raws[5:]
    assert len(be2) == 3


def test_footerless_active_segment_scans_sealed_use_footers(tmp_path, rng,
                                                            monkeypatch):
    root = str(tmp_path / "segs")
    be = SegmentBackend(root, segment_bytes=4 << 10)
    raws = chunks(rng, n=30, size=400)
    cids = be.put_many(raws)
    assert be.segment_count() >= 3          # at least two sealed + active
    be.flush()
    be.close()
    # every sealed file carries the footer trailer magic
    segs = sorted(f for f in os.listdir(root) if f.endswith(".seg"))
    for name in segs[:-1]:
        with open(os.path.join(root, name), "rb") as f:
            f.seek(-8, 2)
            assert f.read() == b"SEGTRLR1"
    # reopen: only the footer-less ACTIVE segment takes the record scan
    scanned = []
    orig = SegmentBackend._scan

    def spy(self, path):
        scanned.append(os.path.basename(path))
        return orig(self, path)

    monkeypatch.setattr(SegmentBackend, "_scan", spy)
    be2 = SegmentBackend(root, segment_bytes=4 << 10)
    assert scanned == [segs[-1]]
    assert be2.get_many(cids) == raws
    be2.close()


def test_segment_replay_restores_stats(tmp_path, rng):
    root = str(tmp_path / "segs")
    be = SegmentBackend(root, segment_bytes=4 << 10, auto_compact=False)
    raws = chunks(rng, n=12, size=500)
    cids = be.put_many(raws)
    be.delete_many(cids[:4])
    be.flush()
    want = {f: getattr(be.stats, f)
            for f in ("puts", "logical_bytes", "physical_bytes",
                      "deletes", "reclaimed_bytes")}
    be.close()
    be2 = SegmentBackend(root, segment_bytes=4 << 10, auto_compact=False)
    got = {f: getattr(be2.stats, f) for f in want}
    assert got == want
    be2.close()


# -------------------------------------------------------- compaction

def test_compaction_reclaims_dead_bytes_per_segment(tmp_path, rng):
    """Acceptance: GC-fed compaction reclaims >= 80% of the dead bytes
    of an over-threshold sealed segment — and ONLY that segment is
    rewritten (no stop-the-world rewrite: untouched files keep their
    inodes)."""
    root = str(tmp_path / "segs")
    be = SegmentBackend(root, segment_bytes=4 << 10)
    raws = chunks(rng, n=40, size=400)
    be.put_many(raws)
    assert be.segment_count() >= 4
    gens = sorted(be._segments)
    victim = gens[0]
    doomed = list(be._segments[victim].live)
    others = {g: os.stat(be._segments[g].path).st_ino
              for g in gens[1:] if os.path.exists(be._segments[g].path)}
    be.delete_many(doomed)                  # the GC sweep's output
    dead = be._segments[victim].dead_bytes
    assert dead > 0
    disk0 = be.disk_bytes()
    be.flush()                              # sweep flush IS the feed
    assert be.stats.compactions >= 1
    reclaimed = disk0 - be.disk_bytes()
    assert reclaimed >= 0.8 * dead
    # other sealed segments were not rewritten
    for g, ino in others.items():
        seg = be._segments.get(g)
        if seg is not None and os.path.exists(seg.path):
            assert os.stat(seg.path).st_ino == ino
    # survivors intact, across a reopen too
    live = sorted(be.iter_cids())
    survivors = be.get_many(live)
    be.close()
    be2 = SegmentBackend(root, segment_bytes=4 << 10)
    assert be2.get_many(live) == survivors
    be2.close()


def test_tombstone_survives_compaction_against_earlier_segment(tmp_path,
                                                               rng):
    """Resurrection hazard: a tombstone living in a LATER segment than
    its dead record must survive that segment's rewrite while the dead
    record is still on disk — dropping it early would replay the dead
    chunk back to life."""
    root = str(tmp_path / "segs")
    be = SegmentBackend(root, segment_bytes=2 << 10, auto_compact=False)
    doomed = encode_chunk(3, rng.bytes(300))
    dcid = be.put(doomed)                   # record lands in segment 1
    filler1 = be.put_many(chunks(rng, n=10, size=300))
    assert be._index[dcid] == 1 and be._active.gen > 1
    be.delete(dcid)                         # tombstone in the active seg
    filler2 = be.put_many(chunks(rng, n=12, size=300))
    tomb_gen = next(g for g, s in be._segments.items() if dcid in s.tombs)
    assert tomb_gen > 1 and be._segments[tomb_gen].sealed
    # kill most of the tombstone's segment so it crosses the threshold,
    # then compact it — WITHOUT touching segment 1 (dead record stays)
    victims = list(be._segments[tomb_gen].live)
    be.delete_many(victims)
    be.compact(tomb_gen)
    assert dcid in be._segments[tomb_gen].tombs   # kept: seg 1 holds it
    be.flush()
    be.close()
    be2 = SegmentBackend(root, segment_bytes=2 << 10, auto_compact=False)
    assert not be2.has(dcid)                # not resurrected
    keep = [c for c in filler1 + filler2 if c not in set(victims)]
    assert all(be2.has_many(keep))
    be2.close()


# ------------------------------------------------------------- tiering

def test_tier_liveness_dirty_chunks_demote_before_eviction(tmp_path, rng):
    """A live chunk is never evicted from its last copy: hot-tier
    overflow writes dirty chunks back to the cold tier first."""
    t = TieredBackend(SegmentBackend(str(tmp_path / "cold")),
                      hot_bytes=2_000)
    raws = chunks(rng, n=30, size=300)      # ~9 KB >> hot capacity
    cids = t.put_many(raws)
    assert t.stats.tier_demotions > 0
    assert t.hot_count < 30
    assert t.get_many(cids) == raws         # every chunk still readable
    assert t.stats.tier_misses > 0 and t.stats.tier_promotions > 0
    t.get_many(cids[-3:])                   # LRU-hot now
    h0 = t.stats.tier_hits
    t.get_many(cids[-3:])
    assert t.stats.tier_hits >= h0 + 3
    assert 0.0 < t.stats.tier_hit_rate < 1.0


def test_tier_flush_makes_everything_durable(tmp_path, rng):
    root = str(tmp_path / "tier")
    t = open_durable(root, hot_bytes=1 << 20)
    raws = chunks(rng, n=10)
    cids = t.put_many(raws)
    assert t.dirty_count == 10              # hot-only so far
    t.flush()
    assert t.dirty_count == 0
    t.close()
    t2 = open_durable(root, hot_bytes=1 << 20)
    assert t2.get_many(cids) == raws
    assert len(t2) == 10
    t2.close()


def test_tier_demote_policy_hook(tmp_path, rng):
    t = TieredBackend(SegmentBackend(str(tmp_path / "cold")),
                      hot_bytes=1 << 20)
    cids = t.put_many(chunks(rng, n=12, size=200))
    shed = t.demote(0)                      # age out the whole hot tier
    assert shed == 12 and t.hot_count == 0 and t.dirty_count == 0
    assert t.get_many(cids)                 # served (and re-promoted) cold
    assert t.stats.tier_promotions >= 12


def test_tier_delete_of_dirty_chunk_never_hits_disk(tmp_path, rng):
    cold = SegmentBackend(str(tmp_path / "cold"))
    t = TieredBackend(cold, hot_bytes=1 << 20)
    cid = t.put(encode_chunk(3, rng.bytes(400)))
    assert t.delete(cid) == 1
    assert len(cold) == 0 and cold.stats.puts == 0
    t.flush()
    assert cold.disk_bytes() == 0           # nothing ever written


# -------------------------------------------------------- engine restart

def test_forkbase_durable_restart_bit_identical_heads(tmp_path, rng):
    root = str(tmp_path / "eng")
    db = ForkBase(durable_root=root)
    m = FMap({b"k%02d" % i: rng.bytes(40) for i in range(30)})
    db.put(b"table", m)
    db.fork(b"table", "master", "dev")
    m2 = db.get(b"table", "dev").map()
    m2.set(b"extra", b"x")
    db.put(b"table", m2, "dev")
    db.sync()
    snap = db.branches.snapshot()
    heads = db.branches.all_heads()
    del db
    db2 = ForkBase(durable_root=root)
    assert db2.branches.snapshot() == snap  # bit-identical
    assert db2.branches.all_heads() == heads
    assert db2.get(b"table", "dev").map().get(b"extra") == b"x"
    # the restarted engine keeps working: put, sync
    db2.put(b"table", FMap({b"a": b"1"}), "dev")
    db2.sync()


def test_forkbase_durable_verified_restart_under_fphash(tmp_path, rng):
    """verify_get with fphash cids: the tiered store re-hashes every
    caller cid on put, the segment store again on demotion and on every
    cold read — the per-chunk path of the single-string fphash entry
    point."""
    from repro_torch.core import FBlob, hashing
    root = str(tmp_path / "eng")
    data = rng.bytes(120_000)
    hashing.use_fphash()
    try:
        db = ForkBase(durable_root=root, verify_get=True,
                      hot_bytes=16 << 10, segment_bytes=32 << 10)
        uid = db.put("doc", FBlob(data))
        assert db.store.stats.verifies > 0          # put-side checks
        assert db.store.cold.stats.verifies > 0     # demotion checks
        db.sync()
        db.store.close()
        db2 = ForkBase(durable_root=root, verify_get=True)
        assert db2.branches.head(b"doc", "master") == uid
        assert db2.get("doc").blob().read() == data
        cold = db2.store.cold.stats
        assert cold.verifies >= cold.gets > 0       # every cold read checked
        assert cold.verify_failures == 0
    finally:
        hashing.use_sha256()


def test_sync_without_durable_root_flushes_only(tmp_path, rng):
    log = str(tmp_path / "chunks.log")
    db = ForkBase(MemoryBackend(log_path=log))
    db.put("k", FMap({b"a": rng.bytes(8)}))
    db.sync()
    assert sorted(os.listdir(tmp_path)) == ["chunks.log"]
    assert len(MemoryBackend(log_path=log)) == len(db.store)


def test_branchtable_snapshot_restore_rebuilds_refcounts():
    bt = BranchTable()
    bt.set_head(b"k1", "master", b"\x01" * 32)
    bt.on_new_version(b"k1", b"\x01" * 32, ())
    bt.fork(b"k1", "dev", b"\x01" * 32)
    bt.on_new_version(b"k2", b"\x02" * 32, (), foc=True)
    blob = bt.snapshot()
    bt2 = BranchTable()
    bt2.restore(blob)
    assert bt2.snapshot() == blob
    assert bt2._head_rc == bt._head_rc      # incremental rc rebuilt
    assert bt2.all_heads() == bt.all_heads()
    # restored table keeps mutating correctly (refcounts consistent)
    bt2.remove(b"k1", "dev")
    assert b"\x01" * 32 in bt2.all_heads()  # master + UB still point at it


# ------------------------------------------------- streaming iter_cids

def test_write_buffer_iter_cids_is_lazy(rng):
    """Satellite regression: iter_cids materialized pending + the whole
    inner inventory as one list; it must stream instead."""
    inner = MemoryBackend()
    stored = inner.put_many(chunks(rng, n=6))
    consumed = []

    real = inner.iter_cids

    def spying():
        for c in real():
            consumed.append(c)
            yield c

    inner.iter_cids = spying
    buf = WriteBuffer(inner)
    pending = buf.put(encode_chunk(3, rng.bytes(64)))
    it = buf.iter_cids()
    assert iter(it) is it                   # an iterator, not a list
    assert next(it) == pending
    assert consumed == []                   # inner untouched so far
    rest = list(it)
    assert sorted(rest) == sorted(stored)


def test_segment_iter_cids_streams_per_segment(tmp_path, rng):
    be = SegmentBackend(str(tmp_path / "segs"), segment_bytes=2 << 10)
    cids = be.put_many(chunks(rng, n=30, size=300))
    it = be.iter_cids()
    assert iter(it) is it
    assert sorted(it) == sorted(cids)
    be.close()


# ----------------------------------------------------------- fuzzing

def _fuzz_episode(root, seed, *, segment_bytes, steps, kill):
    """Seeded put/delete/flush/reopen episode; with ``kill=True`` each
    reopen keeps only a random op-boundary prefix of the unsynced tail
    (simulated power cut: the file loses everything past the cut, plus
    garbage bytes land after it)."""
    rng = np.random.default_rng(seed)
    pool = [encode_chunk(3, rng.bytes(int(rng.integers(30, 280))))
            for _ in range(24)]
    be = SegmentBackend(root, segment_bytes=segment_bytes,
                        auto_compact=not kill)
    model = {cid: be.get(cid) for cid in be.iter_cids()}
    tail = []                               # (op, cid, raw, record bytes)
    base_size = os.path.getsize(be._active.path)

    def reopen(be, model, tail, base_size):
        if kill:
            be._wf.flush()                  # bytes reach the file...
            path = be._active.path
            k = int(rng.integers(0, len(tail) + 1))
            cut = base_size + sum(nb for *_, nb in tail[:k])
            # ...but the tail is lost: unwind it newest-first (the same
            # cid can be deleted then re-put inside one tail)
            for op, cid, raw, _ in reversed(tail[k:]):
                if op == "put":
                    model.pop(cid, None)
                else:
                    model[cid] = raw        # the delete never happened
            be.close()
            os.truncate(path, cut)
            if rng.random() < 0.5:          # garbage after the cut
                with open(path, "ab") as f:
                    f.write(rng.bytes(int(rng.integers(1, 35))))
        else:
            be.flush()
            be.close()
        be = SegmentBackend(root, segment_bytes=segment_bytes,
                            auto_compact=not kill)
        assert sorted(be.iter_cids()) == sorted(model)
        assert be.get_many(list(model)) == list(model.values())
        return be, [], os.path.getsize(be._active.path)

    for _ in range(steps):
        r = rng.random()
        raw = pool[int(rng.integers(len(pool)))]
        cid = cid_of(raw)
        if r < 0.55:
            be.put(raw)
            if cid not in model:
                model[cid] = raw
                tail.append(("put", cid, raw, 36 + len(raw)))
        elif r < 0.85:
            if cid in model:
                be.delete(cid)
                del model[cid]
                tail.append(("del", cid, raw, 36))
        else:
            be, tail, base_size = reopen(be, model, tail, base_size)
    be, _, _ = reopen(be, model, tail, base_size)
    be.close()


def test_segment_reopen_fuzz(tmp_path):
    """Seeded clean-reopen interleavings with SMALL segments: sealing,
    footers, tombstones and auto-compaction all churn under random ops
    and every reopen converges to the model."""
    for seed in range(4):
        _fuzz_episode(str(tmp_path / f"ep{seed}"), 100 + seed,
                      segment_bytes=2 << 10, steps=60, kill=False)


def test_kill_and_replay_fuzz(tmp_path):
    """Seeded kill-and-replay interleavings — every crash keeps an arbitrary
    op-boundary prefix of the unsynced tail and the reopened store must
    equal the surviving-op model exactly.  Episode count scales with
    DURABILITY_FUZZ_EPISODES."""
    episodes = int(os.environ.get("DURABILITY_FUZZ_EPISODES", "12"))
    for seed in range(episodes):
        _fuzz_episode(str(tmp_path / f"kill{seed}"), 9000 + seed,
                      segment_bytes=1 << 30, steps=50, kill=True)
