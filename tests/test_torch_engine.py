"""The port's engine (repro_torch.core) against the JAX package, on the CPU.

One operation sequence runs through both packages and must give identical
uids and root cids, under sha256 and under fphash (with the reference on
its Pallas chunker).  State carried from one engine to the other reads back
with identical bytes, uids and history.  The reference's POS-Tree and API
tests are ported with seeded loops in place of hypothesis.  Every check is
exact.

The hash and chunker hooks are process-global, and xdist runs a whole
file in one worker, so every test that flips one restores it in
``finally``.
"""
import contextlib

import numpy as np
import pytest

import repro.core as rc
from repro.core import hashing as ref_hashing
from repro.kernels.ops import use_pallas_chunker
import repro_torch.core as pc
from repro_torch.core import chunk as ck
from repro_torch.core import hashing
from repro_torch.core.postree import POSTree
from repro_torch.errors import ConfigError
from repro_torch.kernels import golden, ops
from repro_torch.storage import MemoryBackend, make_backend

P8 = pc.ChunkParams(q=8)
REF_P8 = rc.ChunkParams(q=8)


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@contextlib.contextmanager
def fphash_both():
    """fphash cids in both packages; the reference also on its Pallas
    chunker (interpret mode here)."""
    ref_hashing.use_fphash()
    use_pallas_chunker(True)
    hashing.use_fphash()
    try:
        yield
    finally:
        ref_hashing.use_sha256()
        use_pallas_chunker(False)
        hashing.use_sha256()


# ------------------------------------------------------- parity sequence

def run_sequence(core, params, blob_params=None):
    """Blob/List/Map/Set puts, FBlob replace/insert/append, an FMap edit,
    fork, fork-on-conflict puts, merges, track and lca.  Returns every
    observable id.  The blob is built at the default params unless
    ``blob_params`` are given."""
    rng = np.random.default_rng(42)
    db = core.ForkBase(params=params)
    uids = []
    blob_kw = {} if blob_params is None else {"params": blob_params}
    uids.append(db.put("blob", core.FBlob(rng.bytes(40_000), **blob_kw)))
    uids.append(db.put("list", core.FList(
        [rng.bytes(int(rng.integers(1, 200))) for _ in range(200)])))
    items = {f"k{i:04d}".encode(): rng.bytes(24) for i in range(600)}
    uids.append(db.put("map", core.FMap(items)))
    uids.append(db.put("set", core.FSet([f"s{i}".encode()
                                         for i in range(400)])))
    uids.append(db.put("str", core.FString(b"hello")))
    b = db.get("blob").blob()
    b.replace(1000, 50, rng.bytes(50))
    b.insert(20_000, rng.bytes(777))
    b.append(rng.bytes(3000))
    uids.append(db.put("blob", b))
    m = db.get("map").map()
    m.set(b"k0005", b"X")
    m.delete(b"k0100")
    m.set(b"new", b"Y")
    uids.append(db.put("map", m))
    db.fork("map", "master", "dev")
    md = db.get("map", "dev").map()
    md.set(b"k0200", b"DEV")
    uids.append(db.put("map", md, "dev"))
    mm = db.get("map").map()
    mm.set(b"k0300", b"MASTER")
    uids.append(db.put("map", mm))
    uids.append(db.merge("map", "master", "dev"))
    base = uids[-1]
    m1 = db.get("map", uid=base).map()
    m1.set(b"k0001", b"A")
    u1 = db.put("map", m1, base_uid=base)
    m2 = db.get("map", uid=base).map()
    m2.set(b"k0001", b"B")
    u2 = db.put("map", m2, base_uid=base)
    uids += [u1, u2, db.merge("map", u1, u2, resolver=core.choose_one(1))]
    db.fork("blob", "master", "side")
    bs = db.get("blob", "side").blob()
    bs.replace(30_000, 10, b"S" * 10)
    side = db.put("blob", bs, "side")
    bm = db.get("blob").blob()
    bm.replace(100, 10, b"M" * 10)
    master = db.put("blob", bm)
    uids += [side, master, db.merge("blob", "master", "side"),
             db.lca("blob", master, side)]
    roots = [db.get(k).obj.data for k in ("blob", "list", "map", "set")]
    track = [(o.uid, o.depth, o.bases) for o in db.track("map", "master")]
    views = (db.list_keys(), db.list_tagged_branches("map"),
             db.list_untagged_branches("map"), db.diff(uids[0], master))
    return uids, roots, track, views, db.get("blob").blob().read()


def test_sequence_parity_sha256():
    assert run_sequence(pc, P8) == run_sequence(rc, REF_P8)


def test_sequence_parity_fphash():
    with fphash_both():
        got = run_sequence(pc, P8)
        want = run_sequence(rc, REF_P8)
    assert got == want
    assert got[0] != run_sequence(pc, P8)[0]    # sha256 cids differ


@pytest.mark.parametrize("hash_name", ["sha256", "fphash"])
def test_sequence_parity_blob_at_engine_params(hash_name):
    """The sequence with its blob built at the engine's params: the port
    splices the blob's scattered edits as separate clusters, and every id
    is still the reference's."""
    from repro_torch import obs
    with fphash_both() if hash_name == "fphash" else contextlib.nullcontext():
        obs.SPANS.clear()
        got = run_sequence(pc, P8, blob_params=P8)
        clusters = [sp.attrs["clusters"] for sp in obs.SPANS.spans()
                    if sp.name == "tree.splice"]
        want = run_sequence(rc, REF_P8, blob_params=REF_P8)
    assert got == want
    assert max(clusters) >= 2


def test_engine_remembers_the_blob_roots_its_params_cut():
    """A blob built at the engine's params reads back as cut by them and
    splices scattered edits as separate clusters; one built at other
    params splices them as one span from the first edit to the last, as
    the reference does, and both read back the edited bytes."""
    from repro_torch import obs
    rng = np.random.default_rng(21)
    data = rng.bytes(30_000)
    edits = [(1_000, 40, rng.bytes(40)), (15_000, 0, rng.bytes(300)),
             (29_000, 500, b"")]
    db = pc.ForkBase(params=P8)
    ref = rc.ForkBase(params=REF_P8)
    for key, kw, ref_kw in (("own", {"params": P8}, {"params": REF_P8}),
                            ("default", {}, {})):
        db.put(key, pc.FBlob(data, **kw))
        ref.put(key, rc.FBlob(data, **ref_kw))
    for key in ("own", "default"):
        b, rb = db.get(key).blob(), ref.get(key).blob()
        assert b.tree.cut_by_params == (key == "own")
        for pos, n, new in edits:
            b.replace(pos, n, new)
            rb.replace(pos, n, new)
        obs.SPANS.clear()
        uid = db.put(key, b)
        sp = next(sp for sp in obs.SPANS.spans() if sp.name == "tree.splice")
        assert sp.attrs["clusters"] == (3 if key == "own" else 1)
        assert uid == ref.put(key, rb)
        assert db.get(key).blob().tree.cut_by_params == (key == "own")
    got = db.get("own").blob().read()
    assert got == db.get("default").blob().read()
    assert db.get("own").obj.data == POSTree.build_bytes(
        pc.ChunkStore(), got, P8).root_cid


def test_batched_verbs_match_single_puts():
    rng = np.random.default_rng(8)
    vals = [rng.bytes(3000) for _ in range(4)]
    a = pc.ForkBase(params=P8)
    uids = a.put_batch([("k", pc.FBlob(vals[0])), ("k", pc.FBlob(vals[1])),
                        ("j", pc.FBlob(vals[2]), "dev"),
                        ("k", pc.FBlob(vals[3]))])
    b = pc.ForkBase(params=P8)
    assert uids == [b.put("k", pc.FBlob(vals[0])),
                    b.put("k", pc.FBlob(vals[1])),
                    b.put("j", pc.FBlob(vals[2]), "dev"),
                    b.put("k", pc.FBlob(vals[3]))]
    got = a.get_batch([("k",), ("j", "dev"), ("missing",)])
    assert got[0].blob().read() == vals[3]
    assert got[1].blob().read() == vals[2] and got[2] is None


# ------------------------------------------------------------ golden

def test_golden_root_cids_of_reference_and_port():
    blob = golden.blob()
    assert rc.POSTree.build_bytes(rc.ChunkStore(), blob).root_cid.hex() \
        == golden.ROOT_SHA256
    assert POSTree.build_bytes(pc.ChunkStore(), blob).root_cid.hex() \
        == golden.ROOT_SHA256
    with fphash_both():
        ref_root = rc.POSTree.build_bytes(rc.ChunkStore(), blob).root_cid
        port_root = POSTree.build_bytes(pc.ChunkStore(), blob).root_cid
    assert ref_root.hex() == port_root.hex() == golden.ROOT_FPHASH


# ------------------------------------------------------- state carry

def _fill_reference():
    rng = np.random.default_rng(5)
    db = rc.ForkBase(params=REF_P8)
    db.put("doc", rc.FBlob(rng.bytes(30_000)))
    db.fork("doc", "master", "draft")
    d = db.get("doc", "draft").blob()
    d.insert(500, b"inserted text")
    db.put("doc", d, "draft")
    db.put("kv", rc.FMap({b"a": b"1", b"b": b"2"}))
    db.fork("kv", "master", "dev")
    m = db.get("kv", "dev").map()
    m.set(b"a", b"10")
    db.put("kv", m, "dev")
    m = db.get("kv").map()
    m.set(b"b", b"20")
    db.put("kv", m)
    db.merge("kv", "master", "dev")
    db.put("n", rc.FInt(7))
    return db


def _read_all(db, core):
    """Every tagged version: (key, branch, uid, type, value bytes, track)."""
    out = []
    for key in db.list_keys():
        for branch, uid in sorted(db.list_tagged_branches(key).items()):
            h = db.get(key, branch)
            if h.type == core.FBlob.TYPE:
                val = h.blob().read()
            elif h.type == core.FMap.TYPE:
                val = sorted(h.map().items())
            else:
                val = h.obj.data
            track = [(o.uid, o.depth, o.bases, o.data)
                     for o in db.track(key, branch)]
            out.append((key, branch, uid, h.type, val, track))
    return out


def test_state_carries_across_both_ways():
    ref = _fill_reference()
    chunks = dict(ref.store._data)
    port = pc.from_state(chunks, ref.branches.snapshot(), params=P8,
                         store=MemoryBackend(verify=True))
    assert _read_all(port, pc) == _read_all(ref, rc)
    assert port.branches.snapshot() == ref.branches.snapshot()
    # write through the port, carry back: the reference reads it
    b = port.get("doc", "draft").blob()
    b.append(b" -- edited by the port")
    port.put("doc", b, "draft")
    port.put("fresh", pc.FBlob(b"x" * 5000))
    back = rc.ForkBase(params=REF_P8)
    cids = list(port.store._data)
    back.store.put_many([port.store._data[c] for c in cids], cids)
    back.branches.restore(port.branches.snapshot())
    assert _read_all(back, rc) == _read_all(port, pc)
    assert back.get("doc", "draft").blob().read().endswith(b"by the port")


def test_state_carry_rejects_a_wrong_chunk():
    ref = _fill_reference()
    chunks = dict(ref.store._data)
    cid = next(iter(chunks))
    chunks[cid] = b"\x03forged"
    with pytest.raises(pc.TamperedChunk):
        pc.from_state(chunks, ref.branches.snapshot(), params=P8,
                      store=MemoryBackend(verify=True))


def test_make_backend_specs(tmp_path):
    """Every spec of the reference's grammar builds; what cannot be built
    raises the typed ConfigError."""
    from repro_torch.storage import (LRUCacheBackend, ReplicatedBackend,
                                     SegmentBackend, ShardedBackend,
                                     TieredBackend)
    assert isinstance(make_backend("memory"), MemoryBackend)
    log = make_backend("log", log_path=str(tmp_path / "c.log"))
    cid = log.put(b"\x03abc")
    log.flush()
    assert MemoryBackend(log_path=str(tmp_path / "c.log")).get(cid) == \
        b"\x03abc"
    lru = make_backend("lru+sharded", shards=2)
    assert isinstance(lru, LRUCacheBackend)
    assert isinstance(lru.inner, ShardedBackend)
    assert len(lru.inner.shards) == 2
    assert isinstance(make_backend("replicated", n=3, k=2),
                      ReplicatedBackend)
    assert isinstance(make_backend("segment", root=str(tmp_path / "s")),
                      SegmentBackend)
    assert isinstance(make_backend("tiered", root=str(tmp_path / "t")),
                      TieredBackend)
    for spec in ("log", "segment", "tiered", "bogus", "lru+bogus",
                 "cache+memory"):
        with pytest.raises(ConfigError):
            make_backend(spec)


# ------------------------------------------------ POS-Tree (ported)

def build_map(store, items, params=P8):
    items = sorted(items.items())
    els = [ck.pack_kv(k, v) for k, v in items]
    return POSTree.build_elements(store, ck.MAP, els,
                                  [k for k, _ in items], params)


def test_blob_content_determinism():
    rng = np.random.default_rng(10)
    for _ in range(20):
        data = rng.bytes(int(rng.integers(0, 20_000)))
        s = pc.ChunkStore()
        t1 = POSTree.build_bytes(s, data, P8)
        t2 = POSTree.build_bytes(s, bytes(data), P8)
        assert t1.root_cid == t2.root_cid
        assert t1.read_bytes(0, len(data)) == data


def test_map_content_determinism():
    rng = np.random.default_rng(11)
    for _ in range(20):
        items = {rng.bytes(int(rng.integers(1, 13))):
                 rng.bytes(int(rng.integers(0, 41)))
                 for _ in range(int(rng.integers(0, 200)))}
        s = pc.ChunkStore()
        t1 = build_map(s, items)
        t2 = build_map(s, dict(reversed(list(items.items()))))
        assert t1.root_cid == t2.root_cid


def test_blob_splice_equals_rebuild():
    rng = np.random.default_rng(12)
    for _ in range(25):
        data = rng.bytes(int(rng.integers(1, 8000)))
        s = pc.ChunkStore()
        tree = POSTree.build_bytes(s, data, P8)
        cur = data
        for _ in range(int(rng.integers(1, 5))):
            start = min(int(rng.integers(0, 8000)), len(cur))
            end = min(start + int(rng.integers(0, 201)), len(cur))
            rep = rng.bytes(int(rng.integers(0, 101)))
            tree.splice_bytes([(start, end, rep)])
            cur = cur[:start] + rep + cur[end:]
            ref = POSTree.build_bytes(s, cur, P8)
            assert tree.root_cid == ref.root_cid
            assert tree.read_bytes(0, tree.total_count) == cur


# ------------------------------------- clustered splices of scattered edits

def _leaf_ends(tree):
    return np.cumsum([e.count for e in tree.levels[0]]).tolist()


def _rewrite(rng, s, e):
    return (s, e, rng.bytes(e - s))


def _batch_scattered(rng, data, ends):
    k = int(rng.integers(2, 51))
    at = np.sort(rng.choice(np.arange(0, len(data) - 16, 16), k,
                            replace=False))
    return [_rewrite(rng, int(a), int(a) + 1 + int(rng.integers(0, 15)))
            for a in at]


def _batch_one_leaf_apart(rng, data, ends):
    # one edit in every other leaf, then in each of three adjacent leaves
    first = int(rng.integers(1, len(ends) // 2))
    leaves = list(range(first, first + 10, 2)) + [first + 12, first + 13,
                                                  first + 14]
    return [_rewrite(rng, ends[j - 1] + 3, ends[j - 1] + 9) for j in leaves]


def _batch_resync_into_next(rng, data, ends):
    # the first edit ends on its leaf's end and the leaf after it is
    # shorter than the window, so it cannot resync within its first
    # window, which then reaches the second edit's leaf
    sizes = np.diff([0] + ends)
    j = next(j for j in range(1, len(ends) - 6)
             if sizes[j + 1] < P8.window)
    a = _rewrite(rng, ends[j] - 5, ends[j])
    b = _rewrite(rng, ends[j + 2] + 1, ends[j + 2] + 4)
    return [a, b, _rewrite(rng, ends[-4] + 1, ends[-4] + 3)]


def _batch_first_and_last_leaf(rng, data, ends):
    n = len(data)
    return [(0, 4, rng.bytes(9)), _rewrite(rng, ends[len(ends) // 2],
                                           ends[len(ends) // 2] + 5),
            (n - 3, n, rng.bytes(1)), (n, n, rng.bytes(700))]


def _batch_inserts_and_deletes(rng, data, ends):
    k = int(rng.integers(2, 41))
    at = np.sort(rng.choice(np.arange(0, len(data), 64), k, replace=False))
    j = len(ends) // 3
    gone = (ends[j], ends[j + 3])      # a delete of three whole leaves
    out = [(*gone, b"")]
    for i, a in enumerate(at.tolist()):
        if gone[0] - 64 <= a < gone[1]:
            continue
        if i % 3 == 0:
            out.append((a, a, rng.bytes(int(rng.integers(1, 900)))))
        elif i % 3 == 1:
            out.append((a, min(a + int(rng.integers(1, 600)), a + 63,
                               len(data)), b""))
        else:
            out.append((a, a + 10, rng.bytes(int(rng.integers(0, 40)))))
    return sorted(out, key=lambda e: e[0])


def _batch_delete_everything(rng, data, ends):
    cut = sorted(set(rng.choice(len(data), 5, replace=False).tolist()))
    bounds = [0] + cut + [len(data)]
    return [(s, e, b"") for s, e in zip(bounds, bounds[1:])]


SPLICE_BATCHES = {
    "scattered": _batch_scattered,
    "one_leaf_apart": _batch_one_leaf_apart,
    "resync_into_next": _batch_resync_into_next,
    "first_and_last_leaf": _batch_first_and_last_leaf,
    "inserts_and_deletes": _batch_inserts_and_deletes,
    "delete_everything": _batch_delete_everything,
}


def _spliced_bytes(data, edits):
    out, pos = [], 0
    for s, e, rep in edits:
        out += [data[pos:s], rep]
        pos = e
    return b"".join(out + [data[pos:]])


def _splice_cases(name):
    """(data, edits) on blobs of 20 to 200 leaves at P8, seeded by case."""
    rng = np.random.default_rng(list(SPLICE_BATCHES).index(name) + 40)
    for n in (8_000, 20_000, 45_000):
        data = rng.bytes(n)
        ends = _leaf_ends(POSTree.build_bytes(pc.ChunkStore(), data, P8))
        assert 20 <= len(ends) <= 200
        yield data, SPLICE_BATCHES[name](rng, data, ends)


def _splice_span(tree, edits):
    from repro_torch import obs
    obs.SPANS.clear()
    tree.splice_bytes(edits)
    return next(sp for sp in obs.SPANS.spans() if sp.name == "tree.splice")


@pytest.mark.parametrize("name", list(SPLICE_BATCHES))
def test_clustered_splice_equals_rebuild(name):
    """A batch of edits spliced at once, however it clusters, gives the
    tree a fresh build of the edited bytes gives."""
    for data, edits in _splice_cases(name):
        s = pc.ChunkStore()
        tree = POSTree.build_bytes(s, data, P8)
        sp = _splice_span(tree, edits)
        cur = _spliced_bytes(data, edits)
        assert tree.root_cid == POSTree.build_bytes(s, cur, P8).root_cid
        assert tree.read_bytes(0, tree.total_count) == cur
        assert sp.attrs["edits"] == len(edits)
        if name in ("one_leaf_apart", "delete_everything"):
            assert sp.attrs["clusters"] == sp.attrs["attempts"]
        if name == "resync_into_next":
            assert sp.attrs["attempts"] >= 2
        if name == "delete_everything":
            assert tree.total_count == 0


@pytest.mark.parametrize("name", list(SPLICE_BATCHES))
def test_clustered_splice_matches_reference(name):
    """The reference's splice of the same batch (one span from the first
    edit to the last) gives the same root cid."""
    from repro.core.postree import POSTree as RefPOSTree
    for data, edits in _splice_cases(name):
        tree = POSTree.build_bytes(pc.ChunkStore(), data, P8)
        ref = RefPOSTree.build_bytes(rc.ChunkStore(), data, REF_P8)
        assert tree.root_cid == ref.root_cid
        tree.splice_bytes(edits)
        ref.splice_bytes(edits)
        assert tree.root_cid == ref.root_cid
        assert tree.total_count == ref.total_count


@pytest.mark.parametrize("pattern", ["scattered", "contiguous"])
def test_splice_counts_its_clusters(pattern):
    """100 edits at uniform offsets of a blob of over 2,000 leaves
    re-chunk as separate clusters and a small share of the blob; one
    contiguous edit is one cluster."""
    rng = np.random.default_rng(14)
    data = rng.bytes(2_000_000)
    tree = POSTree.build_bytes(pc.ChunkStore(), data, P8)
    assert len(tree.levels[0]) >= 2_000
    if pattern == "scattered":
        at = np.sort(rng.choice(len(data) - 200, 100, replace=False))
        edits = [_rewrite(rng, int(a), int(a) + 180) for a in at]
    else:
        edits = [_rewrite(rng, 300_000, 306_000)]
    sp = _splice_span(tree, edits)
    assert tree.read_bytes(0, tree.total_count) == _spliced_bytes(data,
                                                                  edits)
    if pattern == "scattered":
        assert sp.attrs["clusters"] >= 50
        assert sp.attrs["rechunked"] < len(data) // 10
        assert sp.attrs["leaves_read"] < len(tree.levels[0]) // 4
    else:
        assert sp.attrs["clusters"] == 1 == sp.attrs["attempts"]


def test_map_edits_equal_rebuild():
    """Random set/delete sequences: incremental tree == fresh build."""
    rng = np.random.default_rng(13)
    for _ in range(25):
        items = {rng.bytes(int(rng.integers(1, 11))):
                 rng.bytes(int(rng.integers(0, 31)))
                 for _ in range(int(rng.integers(1, 150)))}
        s = pc.ChunkStore()
        m = pc.FMap(items, params=P8)
        m.commit(s)
        state = dict(items)
        for _ in range(int(rng.integers(1, 7))):
            k = rng.bytes(int(rng.integers(1, 11)))
            if rng.random() < 0.3:
                m.delete(k)
                state.pop(k, None)
            else:
                v = rng.bytes(int(rng.integers(0, 31)))
                m.set(k, v)
                state[k] = v
        m.commit(s)
        assert m.tree.root_cid == build_map(s, state).root_cid


def test_dedup_across_versions():
    s = pc.ChunkStore()
    data = np.random.default_rng(0).integers(0, 256, 200_000, dtype=np.uint8)
    t1 = POSTree.build_bytes(s, data, P8)
    phys0 = s.stats.physical_bytes
    d2 = data.copy()
    d2[1000:1010] = 0
    t2 = POSTree.build_bytes(s, d2, P8)
    added = s.stats.physical_bytes - phys0
    assert added < 0.05 * phys0, f"dedup failed: {added}/{phys0}"
    shared = t1.node_cids() & t2.node_cids()
    assert len(shared) > 0.8 * len(t1.node_cids())


def test_cross_object_dedup():
    rng = np.random.default_rng(0)
    s = pc.ChunkStore()
    base = rng.integers(0, 256, 100_000, dtype=np.uint8)
    POSTree.build_bytes(s, base, P8)
    phys0 = s.stats.physical_bytes
    other = np.concatenate([rng.integers(0, 256, 512, dtype=np.uint8), base])
    POSTree.build_bytes(s, other, P8)   # a *different* object, shared tail
    assert s.stats.physical_bytes - phys0 < 0.1 * phys0


def test_diff_keys_precision():
    rng = np.random.default_rng(0)
    s = pc.ChunkStore()
    items = {f"k{i:05d}".encode(): rng.bytes(20) for i in range(3000)}
    t1 = build_map(s, items)
    items2 = dict(items)
    items2[b"k00777"] = b"CHANGED"
    items2[b"knew"] = b"ADDED"
    del items2[b"k01234"]
    t2 = build_map(s, items2)
    a, r, c = t2.diff_keys(t1)
    assert a == [b"knew"] and r == [b"k01234"] and c == [b"k00777"]


def test_lookup_paths():
    rng = np.random.default_rng(0)
    s = pc.ChunkStore()
    items = {f"k{i:05d}".encode(): rng.bytes(16) for i in range(2000)}
    t = build_map(s, items)
    assert t.descend_key(b"k00500") == items[b"k00500"]
    found, j, li, gi = t.find_key(b"k01999")
    assert found and t.get_item(gi) == (b"k01999", items[b"k01999"])
    t2 = POSTree.from_root(s, ck.MAP, t.root_cid, P8)
    assert t2.root_cid == t.root_cid
    assert t2.descend_key(b"k00001") == items[b"k00001"]


def test_tamper_evidence():
    """A verifying store raises the typed TamperedChunk (the reference's
    copy of this test expects AssertionError, which TamperedChunk is not)."""
    s = pc.ChunkStore(verify=True)
    data = np.random.default_rng(0).integers(0, 256, 50_000, dtype=np.uint8)
    t = POSTree.build_bytes(s, data, P8)
    cid = t.levels[0][3].cid
    s._data[cid] = b"\x03tampered!"          # corrupt a stored chunk
    with pytest.raises(pc.TamperedChunk):
        s.get(cid)


def test_verify_get_catches_a_forged_meta_chunk():
    for use_fp in (False, True):
        db = pc.ForkBase(params=P8, verify_get=True)
        if use_fp:
            hashing.use_fphash()
        try:
            uid = db.put("k", pc.FString(b"v"))
            assert db.get("k").string().value == b"v"
            db.store._data[uid] = pc.FObject(
                9, b"k", b"forged", 0, ()).serialize()
            with pytest.raises(pc.TamperedChunk):
                db.get("k")
            assert db.store.stats.verify_failures == 1
        finally:
            hashing.use_sha256()


# --------------------------------------------------------- API (ported)

@pytest.fixture
def db():
    return pc.ForkBase(params=P8)


def test_basic_kv_compliance(db):
    db.put("k", pc.FString(b"v1"))
    assert db.get("k").string().value == b"v1"
    db.put("k", pc.FString(b"v2"))
    assert db.get("k").string().value == b"v2"
    assert db.list_keys() == [b"k"]


def test_fig4_flow(db):
    db.put("my key", pc.FBlob(b"my value" * 50))
    db.fork("my key", "master", "new branch")
    b = db.get("my key", "new branch").blob()
    b.remove(0, 10)
    b.append(b"some more")
    db.put("my key", b, "new branch")
    assert db.get("my key", "new branch").blob().read() == \
        (b"my value" * 50)[10:] + b"some more"
    assert db.get("my key", "master").blob().read() == b"my value" * 50


def test_track_and_lca(db):
    uids = [db.put("k", pc.FInt(i)) for i in range(5)]
    assert [o.uid for o in db.track("k", "master")] == uids[::-1]
    assert [o.uid for o in db.track("k", "master", (1, 3))] == \
        uids[::-1][1:3]
    db.fork("k", uids[2], "side")
    u_side = db.put("k", pc.FInt(99), "side")
    assert db.lca("k", uids[4], u_side) == uids[2]


def test_foc_untagged_branches(db):
    base = db.put("s", pc.FMap({b"x": b"0"}))
    m1 = db.get("s", uid=base).map()
    m1.set(b"x", b"1")
    u1 = db.put("s", m1, base_uid=base)
    m2 = db.get("s", uid=base).map()
    m2.set(b"x", b"2")
    u2 = db.put("s", m2, base_uid=base)
    heads = db.list_untagged_branches("s")
    assert u1 in heads and u2 in heads and base not in heads
    with pytest.raises(pc.MergeConflict):
        db.merge("s", u1, u2)
    merged = db.merge("s", u1, u2, resolver=pc.choose_one(1))
    assert db.get("s", uid=merged).map().get(b"x") == b"2"
    assert set(db.list_untagged_branches("s")) >= {merged}


def test_merge_branches_m5(db):
    db.put("k", pc.FMap({b"a": b"1", b"b": b"2"}))
    db.fork("k", "master", "dev")
    md = db.get("k", "dev").map()
    md.set(b"a", b"10")
    db.put("k", md, "dev")
    mm = db.get("k", "master").map()
    mm.set(b"b", b"20")
    db.put("k", mm, "master")
    db.merge("k", "master", "dev")
    final = db.get("k", "master").map()
    assert final.get(b"a") == b"10" and final.get(b"b") == b"20"


def test_guarded_put(db):
    db.put("g", pc.FString(b"v1"))
    h = db.get("g").uid
    db.put("g", pc.FString(b"v2"), guard_uid=h)
    with pytest.raises(pc.GuardFailed):
        db.put("g", pc.FString(b"v3"), guard_uid=h)


def test_branch_ops(db):
    db.put("k", pc.FString(b"x"))
    db.fork("k", "master", "b1")
    db.rename("k", "b1", "b2")
    assert "b2" in db.list_tagged_branches("k")
    db.remove("k", "b2")
    assert "b2" not in db.list_tagged_branches("k")
    with pytest.raises(pc.NoSuchRef):
        db.fork("k", b"\x00" * 32, "dangling")


def test_primitive_merges(db):
    base = db.put("n", pc.FInt(10))
    c1 = db.get("n", uid=base).integer()
    c1.add(5)
    u1 = db.put("n", c1, base_uid=base)
    c2 = db.get("n", uid=base).integer()
    c2.add(7)
    u2 = db.put("n", c2, base_uid=base)
    m = db.merge("n", u1, u2, resolver=pc.aggregate_resolver)
    assert db.get("n", uid=m).integer().value == 22


def test_list_and_set_types(db):
    db.put("l", pc.FList([b"a", b"b", b"c"]))
    ll = db.get("l").list()
    ll.insert(1, b"x")
    ll.delete(3)
    db.put("l", ll)
    assert list(db.get("l").list()) == [b"a", b"x", b"b"]
    db.put("st", pc.FSet([b"p", b"q"]))
    ss = db.get("st").set()
    ss.add(b"r")
    ss.remove(b"p")
    db.put("st", ss)
    assert set(db.get("st").set()) == {b"q", b"r"}


def test_cluster_balance(rng):
    counts = {}
    for mode in ("1LP", "2LP"):
        cl = pc.Cluster(8, mode, P8)
        r = np.random.default_rng(1)
        for i in range(40):
            cl.put(f"hot{i % 2}", pc.FBlob(r.bytes(16000)), branch=f"b{i}")
        dist = cl.storage_distribution()
        counts[mode] = (max(dist) + 1) / (min(dist) + 1)
    assert counts["2LP"] < counts["1LP"]


def test_cluster_api_roundtrip():
    cl = pc.Cluster(4, "2LP", P8)
    cl.put("k", pc.FBlob(b"hello world" * 100))
    assert cl.get("k").blob().read() == b"hello world" * 100
    cl.fork("k", "master", "dev")
    b = cl.get("k", "dev").blob()
    b.append(b"!")
    cl.put("k", b, "dev")
    assert cl.get("k", "dev").blob().read().endswith(b"!")
    assert len(cl.track("k", "dev")) == 2
