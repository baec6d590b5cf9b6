"""Chunk storage durability + replication + cluster rebalancing
(paper §4.4, §4.6.1) of the port (repro_torch), on the CPU — the JAX
package's ``tests/test_store_cluster.py``, every test of it — and a
rehearsal of phase 7 of ``chip_smoke.py``, the cluster path, at a small
size with the kernels' plain versions."""
import pytest

from repro_torch.core import (ChunkParams, ChunkStore, Cluster, FBlob,
                              ReplicatedStore)
from repro_torch.core.chunk import cid_of, encode_chunk
from repro_torch.kernels import ops
from torch_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def test_log_persistence_and_replay(tmp_path, rng):
    log = str(tmp_path / "chunks.log")
    s = ChunkStore(log_path=log)
    cids = [s.put(encode_chunk(3, rng.bytes(500))) for _ in range(20)]
    s.flush()
    s2 = ChunkStore(log_path=log)          # replay
    for c in cids:
        assert s2.has(c)
        assert cid_of(s2.get(c)) == c


def test_log_torn_tail_recovery(tmp_path, rng):
    log = str(tmp_path / "chunks.log")
    s = ChunkStore(log_path=log)
    cids = [s.put(encode_chunk(3, rng.bytes(300))) for _ in range(10)]
    s.flush()
    with open(log, "ab") as f:             # simulate torn write at crash
        f.write(b"\x00" * 17)
    s2 = ChunkStore(log_path=log)
    for c in cids:                          # prefix fully recovered
        assert s2.has(c)


def test_replicated_store_failover(rng):
    stores = [ChunkStore() for _ in range(4)]
    rs = ReplicatedStore(stores, k=2)
    cid = rs.put(encode_chunk(3, rng.bytes(1000)))
    # exactly k replicas exist
    assert sum(1 for s in stores if s.has(cid)) == 2
    # kill the primary replica: get() fails over
    for s in stores:
        if s.has(cid):
            del s._data[cid]
            break
    assert cid_of(rs.get(cid)) == cid


def test_dedup_across_replicated_puts(rng):
    stores = [ChunkStore() for _ in range(3)]
    rs = ReplicatedStore(stores, k=2)
    raw = encode_chunk(3, rng.bytes(2000))
    rs.put(raw)
    rs.put(raw)                              # duplicate put
    total = sum(s.stats.physical_bytes for s in stores)
    assert total == 2 * len(raw)             # k copies, not 2k (§4.4)


def test_cluster_build_rebalancing(rng):
    """§4.6.1: an overloaded servlet delegates POS-Tree construction to
    the least-loaded peer — build work spreads even when one key is hot."""
    cl = Cluster(4, "2LP", ChunkParams(q=8))
    for i in range(60):
        cl.put("hotkey", FBlob(rng.bytes(30000)), branch=f"b{i}")
    dist = cl.build_distribution()
    assert max(dist) < 0.75 * sum(dist), dist   # not all on one node


def test_meta_chunks_stay_local(rng):
    """§4.6: meta chunks pin to the key's servlet; data chunks spread."""
    cl = Cluster(4, "2LP", ChunkParams(q=8))
    cl.put("k", FBlob(rng.bytes(50000)))
    from repro_torch.core.cluster import _h
    home = _h(b"k") % 4
    from repro_torch.core import chunk as ck
    meta_nodes = set()
    for cid, node in cl.index.items():
        # repro: allow(PERF001): each cid lives on a different node —
        # there is no single store to batch against
        raw = cl.nodes[node].store.get(cid)
        if ck.chunk_type(raw) == ck.META:
            meta_nodes.add(node)
    assert meta_nodes == {home}


def test_cluster_phase_rehearsal_on_the_cpu():
    """Phase 7 of chip_smoke.py at a small size on the CPU, with the
    kernels' plain versions: every check of the phase holds (the
    dataset is the smallest whose 1%-edited version stays under 5% new
    bytes; the skew the smallest whose 2LP spread stays under 0.10)."""
    import pathlib
    import sys

    import torch
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    ds = chip_smoke.make_dataset(40_000, 10)
    dds = chip_smoke.make_dataset(10_000, 0)
    out = chip_smoke.cluster_path(
        torch.device("cpu"), ds, chip_smoke.memory_uids(ds), dds,
        chip_smoke.memory_uids(dds)[0], skew_edits=1600, writers=3,
        puts_each=16, coalesce_ops=16)
    full, skew, rt = out["full_width"], out["skew"], out["runtime"]
    assert full["v2_new_bytes"] < 0.05 * full["bytes"]
    assert full["balance"] < chip_smoke.MAX_BALANCE
    assert sum(full["distribution_1lp"]) == \
        full["distribution_1lp"][full["home_1lp"]]
    assert skew["2LP"]["cv"] < skew["1LP"]["cv"]
    assert 0 < rt["done_at_quarantine"] < rt["puts"]
    assert rt["rerep_done"] >= rt["quarantine_backlog"] > 0
    assert rt["distribution"][0] == 0 and rt["rerep_lost"] == 0
    assert rt["coalescing"]["coalesced_put_batches"] < \
        rt["coalescing"]["per_request_put_batches"]
    # every placement, plus the head the engine audit checks
    assert out["durable"]["audit_chunks"] == \
        out["durable"]["index_chunks"] + 1
    assert out["max_abs_err"] == {"boundary_bitmap": 0, "fphash_many": 0,
                                  "fphash": 0}
    assert set(out["launches"]) == {"full_width", "skew", "runtime",
                                    "durable"}
