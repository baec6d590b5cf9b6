"""The paper's applications on the port (repro_torch.apps), on the CPU:
blockchain, wiki and analytics against their baselines.

The JAX package's ``tests/test_apps.py``, plus ``tests/test_system.py``'s
``test_end_to_end_collaboration`` (slow, as that module marks it)."""
import pytest

from repro_torch.apps import (ColumnTable, ForkBaseLedger, ForkBaseWiki,
                              KVLedger, OrpheusLite, RedisWiki, RowTable)
from repro_torch.core import ChunkParams, FMap, ForkBase
from repro_torch.kernels import ops

P8 = ChunkParams(q=8)


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def test_blockchain_equivalence(rng):
    fb, kv = ForkBaseLedger(ForkBase(params=P8)), KVLedger("bucket", 64)
    for blk in range(5):
        for i in range(8):
            k, v = f"k{(blk * 8 + i) % 12}", f"v{blk}.{i}".encode()
            fb.write("c", k, v)
            kv.write("c", k, v)
        fb.commit()
        kv.commit()
    idx = kv.build_scan_index()
    for key in ["k0", "k5", "k11"]:
        h_fb = [v for _, v in fb.state_scan("c", key)]
        h_kv = kv.state_scan("c", key, idx)
        assert h_fb == h_kv, key
    s_fb, s_kv = fb.block_scan(2), kv.block_scan(2)
    for (c, k), v in s_fb.items():
        assert s_kv[f"{c}/{k}".encode()] == v
    assert fb.verify_block(0) and fb.verify_block(4)


def test_blockchain_tamper_detection(rng):
    fb = ForkBaseLedger(ForkBase(params=P8))
    fb.write("c", "k", b"v1")
    u1 = fb.commit()
    fb.write("c", "k", b"v2")
    u2 = fb.commit()
    # a block not on the chain cannot be proven part of it
    other = ForkBaseLedger(ForkBase(params=P8))
    other.write("c", "k", b"evil")
    u_evil = other.commit()
    assert not fb.db.verify_lineage(u2, u_evil)


def test_wiki_vs_redis(rng):
    w, r = ForkBaseWiki(ForkBase(params=P8)), RedisWiki()
    text = rng.bytes(15000)
    w.create("p", text)
    r.create("p", text)
    cur = text
    for _ in range(10):
        pos = int(rng.integers(0, len(cur) - 100))
        ins = rng.bytes(64)
        cur = cur[:pos] + ins + cur[pos:]
        w.edit("p", lambda b, q=pos, s=ins: b.insert(q, s))
        r.edit("p", cur)
    assert w.load("p") == r.load("p") == cur
    for back in range(3):
        v, _, _ = w.read_version("p", back, None)
        assert v == r.read_version("p", back)
    assert w.storage_bytes() < 0.5 * sum(
        len(v) for vs in [[text] * 11] for v in vs), "dedup should win"


def test_wiki_chunk_cache(rng):
    w = ForkBaseWiki(ForkBase(params=P8))
    text = rng.bytes(20000)
    w.create("p", text)
    w.edit("p", lambda b: b.insert(100, b"xyz"))
    cache: set = set()
    _, f0, c0 = w.read_version("p", 0, cache)
    _, f1, c1 = w.read_version("p", 1, cache)
    # consecutive version mostly cache-hits (only the edited chunk differs)
    assert c1 >= 0.6 * (f1 + c1), (f1, c1)
    assert f1 <= 2


def test_analytics_row_col_orpheus(rng):
    db = ForkBase(params=P8)
    n = 1500
    recs = [[f"pk{i:06d}".encode(), str(i % 97).encode(),
             str(i % 13).encode(), rng.bytes(30)] for i in range(n)]
    rt = RowTable(db, "ds")
    u0 = rt.load({r[0]: r for r in recs})
    ol = OrpheusLite()
    v0 = ol.load(recs)
    ct = ColumnTable(db, "dsc", ["pk", "a", "b", "pay"])
    ct.load(recs)
    want = sum(i % 97 for i in range(n))
    assert rt.aggregate(1) == ol.aggregate(v0, 1) == ct.aggregate("a") \
        == want
    ups = {recs[i][0]: [recs[i][0], b"0", b"0", b"u"]
           for i in range(0, n, 50)}
    u1 = rt.update(ups)
    v1 = ol.commit(v0, {i: ups[recs[i][0]] for i in range(0, n, 50)})
    a, r, c = rt.diff(u1, u0)
    assert len(c) == len(ol.diff(v0, v1)) == len(ups)
    # fork isolation
    rt.fork("branchA")
    rtA = RowTable(db, "ds", "branchA")
    rtA.update({recs[0][0]: [recs[0][0], b"777", b"0", b"x"]})
    assert rt.get(recs[0][0])[1] == b"0"
    assert rtA.get(recs[0][0])[1] == b"777"


# ------------------------------------------------- tests/test_system.py

@pytest.mark.slow
def test_end_to_end_collaboration(rng):
    """Two 'analysts' fork a dataset, edit independently, merge cleanly;
    storage stays deduplicated; history stays verifiable."""
    db = ForkBase(params=ChunkParams(q=8))
    m = FMap({f"row{i:04d}".encode(): rng.bytes(40) for i in range(800)})
    base_uid = db.put("data", m)
    db.fork("data", "master", "alice")
    db.fork("data", "master", "bob")
    ma = db.get("data", "alice").map()
    ma.set(b"row0001", b"alice-edit")
    ua = db.put("data", ma, "alice")
    mb = db.get("data", "bob").map()
    mb.set(b"row0500", b"bob-edit")
    ub = db.put("data", mb, "bob")
    db.merge("data", "master", "alice")
    db.merge("data", "master", "bob")
    final = db.get("data", "master").map()
    assert final.get(b"row0001") == b"alice-edit"
    assert final.get(b"row0500") == b"bob-edit"
    head = db.get("data", "master").uid
    assert db.verify_lineage(head, base_uid)
    assert db.store.stats.dedup_ratio > 1.15  # forks+merges share chunks


# ------------------------------------------- chip_smoke.py, phase 6

def test_ledger_phase_rehearsal_on_the_cpu():
    """Phase 6 of chip_smoke.py at a small size on the CPU, with the
    kernels' plain versions: every check of the phase holds."""
    import pathlib
    import sys

    import torch
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.ledger_path(torch.device("cpu"), accounts=500,
                                 blocks=2, proofs=8, archive_accounts=20,
                                 archive_blocks=1, archive_proofs=4,
                                 churn=(16, 3, 2))
    assert out["live"]["roots_bit_identical"]
    assert out["live"]["proofs"] == 8
    assert out["live"]["state_load_ms"] > 0
    assert out["archival"]["audit_copies"] == \
        3 * out["archival"]["audit_chunks"]
    assert out["churn"]["delta_stats"]["delta_refreshes"] == 2
    assert set(out["launches"]) == {"live", "churn", "archival", "audit"}
