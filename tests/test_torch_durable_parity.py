"""The durable stores of the port against the JAX package, byte for byte.

* One seeded sequence of segment-store operations (puts that seal several
  segments, deletes, a flush that compacts, a torn active tail, a reopen)
  runs through ``repro.storage.SegmentBackend`` and
  ``repro_torch.storage.SegmentBackend`` in two directories; both must end
  with the same file names and the same bytes.
* One ``ForkBase(durable_root=...)`` sequence (Blob and Map puts, a fork,
  a fork-on-conflict put, ``sync()``) runs through both packages, under
  sha256 and under fphash (the reference on its Pallas chunker, in
  interpret mode here); ``heads.json`` and every segment file must be
  identical.
* A root written by either package opens in the other with
  ``verify_get=True``: the same branch table, heads and values.

Every check is exact.  The hash and chunker hooks are process-global, so
every test that flips one restores it in ``finally``.
"""
import contextlib
import os

import numpy as np
import pytest

import repro.core as rc
import repro.storage as rs
from repro.core import hashing as ref_hashing
from repro.core.chunk import encode_chunk as ref_encode_chunk
from repro.kernels.ops import use_pallas_chunker
import repro_torch.core as pc
import repro_torch.storage as ps
from repro_torch.core import hashing
from repro_torch.core.chunk import encode_chunk
from repro_torch.kernels import ops

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


@contextlib.contextmanager
def cid_hash(name):
    if name == "fphash":
        with fphash_both():
            yield
    else:
        yield


def tree_bytes(root) -> dict[str, bytes]:
    """Every file under ``root``, by its path relative to ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_encode_chunk_is_the_same_in_both_packages():
    payload = np.random.default_rng(3).bytes(77)
    assert encode_chunk(5, payload) == ref_encode_chunk(5, payload)


# ---------------------------------------------------------- segment store

def segment_sequence(storage, root) -> dict:
    """Seeded segment-store operations; returns what the store reports."""
    rng = np.random.default_rng(7)
    pool = [encode_chunk(3, rng.bytes(int(rng.integers(40, 700))))
            for _ in range(60)]
    be = storage.SegmentBackend(root, segment_bytes=4 << 10)
    cids = be.put_many(pool[:40])
    sealed = be.segment_count()
    be.put_many(pool[:10])                       # dedup acks: no records
    first = sorted(be._segments)[0]
    be.delete_many(list(be._segments[first].live))   # kill one segment
    be.delete_many(cids[30:33])
    be.flush()                                   # fsync + compaction
    compactions = be.stats.compactions
    be.put_many(pool[40:50])
    be.flush()
    be.close()
    # crash mid-append: a torn record at the end of the active segment
    active = sorted(n for n in os.listdir(root) if n.endswith(".seg"))[-1]
    with open(os.path.join(root, active), "ab") as f:
        f.write(rng.bytes(32) + b"\xe8\x03\x00\x00" + b"torn payload")
    be = storage.SegmentBackend(root, segment_bytes=4 << 10)
    be.delete_many(cids[:2] + cids[35:37])
    be.put_many(pool[50:] + pool[30:31])         # a re-put after delete
    be.flush()
    out = {"sealed": sealed, "compactions": compactions,
           "segments": be.segment_count(), "len": len(be),
           "cids": sorted(be.iter_cids()),
           "stats": {f: getattr(be.stats, f)
                     for f in ("puts", "logical_bytes", "physical_bytes",
                               "deletes", "reclaimed_bytes")}}
    be.close()
    return out


def test_segment_files_are_byte_identical(tmp_path):
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    want = segment_sequence(rs, ref_root)
    got = segment_sequence(ps, port_root)
    assert got == want
    assert want["sealed"] >= 3 and want["compactions"] >= 1
    ref_files, port_files = tree_bytes(ref_root), tree_bytes(port_root)
    assert sorted(port_files) == sorted(ref_files)
    assert port_files == ref_files


def test_segment_roots_open_in_the_other_package(tmp_path):
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    segment_sequence(rs, roots["ref"])
    segment_sequence(ps, roots["port"])
    for writer, reader in (("ref", ps), ("port", rs)):
        own = (rs if writer == "ref" else ps).SegmentBackend(roots[writer])
        other = reader.SegmentBackend(roots[writer], verify=True)
        cids = sorted(own.iter_cids())
        assert sorted(other.iter_cids()) == cids
        assert other.get_many(cids) == own.get_many(cids)
        assert other.stats.physical_bytes == own.stats.physical_bytes
        own.close()
        other.close()


# -------------------------------------------------------- durable engine

def engine_sequence(core, params, root) -> dict:
    """Seeded durable-engine operations, then ``sync()``; returns every
    uid and the branch table."""
    rng = np.random.default_rng(11)
    db = core.ForkBase(params=params, durable_root=root,
                       hot_bytes=16 << 10, segment_bytes=32 << 10)
    uids = [db.put("blob", core.FBlob(rng.bytes(60_000)))]
    items = {f"k{i:04d}".encode(): rng.bytes(24) for i in range(400)}
    uids.append(db.put("map", core.FMap(items)))
    base = uids[-1]
    db.fork("blob", "master", "dev")
    b = db.get("blob", "dev").blob()
    b.replace(10_000, 40, rng.bytes(40))
    b.append(rng.bytes(3000))
    uids.append(db.put("blob", b, "dev"))
    m = db.get("map").map()
    m.set(b"k0007", b"MASTER")
    uids.append(db.put("map", m))
    m = db.get("map", uid=base).map()             # base is derived already:
    m.set(b"k0007", b"FOC")                       # fork on conflict
    uids.append(db.put("map", m, base_uid=base))
    db.put("note", core.FString(b"durable"))
    db.sync()
    out = {"uids": uids, "snapshot": db.branches.snapshot(),
           "untagged": db.list_untagged_branches("map")}
    db.store.close()
    return out


def read_value(h):
    """A handle's value in plain Python (the type names match across the
    two packages)."""
    if h.type == pc.FBlob.TYPE:
        return h.blob().read()
    if h.type == pc.FMap.TYPE:
        return list(h.map().items())
    return h.obj.data


def read_all(db) -> dict:
    """Every tagged and untagged head of every key, with its value."""
    out = {}
    for key in db.list_keys():
        for branch, uid in sorted(db.list_tagged_branches(key).items()):
            out[(key, branch)] = (uid, read_value(db.get(key, branch)))
        for uid in db.list_untagged_branches(key):
            out[(key, uid)] = read_value(db.get(key, uid=uid))
    return out


@pytest.mark.parametrize("hash_name", ["sha256", "fphash"])
def test_engine_roots_are_byte_identical(tmp_path, hash_name):
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    with cid_hash(hash_name):
        want = engine_sequence(rc, REF_P8, ref_root)
        got = engine_sequence(pc, P8, port_root)
    assert got == want
    assert len(want["untagged"]) >= 2             # the FoC put forked
    ref_files, port_files = tree_bytes(ref_root), tree_bytes(port_root)
    assert "heads.json" in ref_files
    assert sum(n.startswith("segments") for n in ref_files) >= 3
    assert sorted(port_files) == sorted(ref_files)
    assert port_files == ref_files


@pytest.mark.parametrize("hash_name", ["sha256", "fphash"])
def test_engine_roots_open_in_the_other_package(tmp_path, hash_name):
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    with cid_hash(hash_name):
        written = {"ref": engine_sequence(rc, REF_P8, roots["ref"]),
                   "port": engine_sequence(pc, P8, roots["port"])}
        for writer, core, params in (("ref", pc, P8), ("port", rc, REF_P8)):
            db = core.ForkBase(params=params, durable_root=roots[writer],
                               verify_get=True)
            assert db.branches.snapshot() == written[writer]["snapshot"]
            heads = db.branches.all_heads()
            assert set(written[writer]["uids"][2:]) <= heads
            got = read_all(db)
            own = (rc if writer == "ref" else pc).ForkBase(
                params=REF_P8 if writer == "ref" else P8,
                durable_root=roots[writer], verify_get=True)
            assert got == read_all(own)
            assert db.store.cold.stats.verifies > 0
            assert db.store.cold.stats.verify_failures == 0
            db.store.close()
            own.store.close()
