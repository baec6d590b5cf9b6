"""The cluster and its runtime of the port against the JAX package, on the
CPU.

One seeded sequence of cluster operations runs through ``repro.core.Cluster``
and ``repro_torch.core.Cluster``, under sha256 and under fphash cids (the
reference on its Pallas kernels, in interpret mode here), in 1LP and in 2LP
placement.  Both must give the same uids, master index, storage and build
distributions, the ``"cluster"`` section of ``observe()``, routing put
batches of coalesced and of per-request dispatch, ``MaintenanceDaemon.tick()``
reports under ``drain()``, cluster and servlet attestation roots,
``GCReport``s (stop-the-world and incremental) and re-replication counters
after a quarantine.

A durable cluster root written by either package opens in the other with
the same branch table on every node, the same index, and every value; the
two packages' roots from one sequence are byte-identical (compared within
this process, since a tiered store demotes in the order of a Python set of
bytes, which follows the process's hash seed).

Every check is exact.  The hash and chunker hooks are process-global, so
every test that flips one restores it in ``finally``.
"""
import contextlib
import dataclasses
import os
import types

import numpy as np
import pytest

import repro.core as rc
from repro import obs as ref_obs
from repro.core import hashing as ref_hashing
from repro.kernels.ops import use_pallas_chunker
import repro_torch.core as pc
from repro_torch import obs as port_obs
from repro_torch.core import hashing
from repro_torch.kernels import ops

REF = types.SimpleNamespace(core=rc, obs=ref_obs, params=rc.ChunkParams(q=8))
PORT = types.SimpleNamespace(core=pc, obs=port_obs,
                             params=pc.ChunkParams(q=8))
SECRET = b"cluster-attest-key"


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@contextlib.contextmanager
def cid_hash(name):
    """sha256 (the default) or fphash cids in both packages; under fphash
    the reference also chunks with its Pallas kernel."""
    if name == "fphash":
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
def fresh_obs(pkg):
    """Each run starts from an empty registry: the daemon's backoff reads
    the routing store's put-histogram count."""
    pkg.obs.reset()
    pkg.obs.enable()
    try:
        yield
    finally:
        pkg.obs.reset()
        pkg.obs.enable()


def put_batches(cl) -> int:
    return sum(n.servlet.store.stats.put_batches for n in cl.nodes)


def cluster_state(cl) -> dict:
    section = cl.observe()["cluster"]
    return {"index": dict(cl.index),
            "storage": cl.storage_distribution(),
            "build": cl.build_distribution(),
            "observe": section,
            "snapshots": [n.servlet.branches.snapshot() for n in cl.nodes]}


def read_or_miss(core, cl, key):
    """The key's bytes, or the cid of the chunk whose index entry the
    re-replication dropped (a typed miss, not bad bytes)."""
    try:
        return cl.get(key).blob().read()
    except core.RoutingIndexMiss as e:
        return ("miss", e.cid)


# ----------------------------------------------------------- the sequence

def run_sequence(pkg, mode: str, scale: int) -> dict:
    """Puts of Blobs and a Map on many keys, a hot key with a branch per
    put (construction rebalancing), a fork, a live table folded by
    ``commit_epoch``, coalesced runtime puts and gets, daemon ticks with a
    GC cycle and staggered folds, a signed attestation, a stop-the-world
    and an incremental collection, and a quarantine with one corrupt chunk
    re-replicated.  ``scale`` sizes the values.  Returns every
    observable."""
    core = pkg.core
    rng = np.random.default_rng(17)
    out: dict = {"uids": []}
    uids = out["uids"]
    with fresh_obs(pkg):
        cl = core.Cluster(4, mode, pkg.params)
        for i in range(6):
            uids.append(cl.put(f"key{i}",
                               core.FBlob(rng.bytes(scale * (3 + i)))))
        for i in range(8):
            uids.append(cl.put("hot", core.FBlob(rng.bytes(6 * scale)),
                               branch=f"b{i}"))
        uids.append(cl.put("map", core.FMap(
            {b"e%03d" % j: rng.bytes(16) for j in range(scale // 5)})))
        cl.fork("key0", "master", "dev")
        b = cl.get("key0", "dev").blob()
        b.append(rng.bytes(scale // 2))
        uids.append(cl.put("key0", b, "dev"))
        t = cl.live("ledger")
        for j in range(12):
            t.put(b"acct%02d" % j, rng.bytes(8))
        out["epoch"] = [[(f.key, f.branch, f.uid, f.folded_keys)
                         for f in r.folds]
                        for r in cl.commit_epoch(context=b"e0")]
        out["after_puts"] = cluster_state(cl)

        # coalesced dispatch: fewer than max_batch / 2 requests a drain,
        # so a timing-driven admission verdict cannot change the batches
        rt = cl.runtime()
        b0 = put_batches(cl)
        futs = [rt.submit_put(f"rt{i}", core.FBlob(rng.bytes(scale)))
                for i in range(12)]
        futs.append(rt.submit_put("rt0", core.FBlob(rng.bytes(scale))))
        gets = [rt.submit_get(f"rt{i}") for i in range(3)]
        gets.append(rt.submit_get("never-written"))
        out["drained"] = rt.drain()
        uids.extend(f.result() for f in futs)
        out["gets"] = [None if g.result() is None else
                       g.result().blob().read() for g in gets]
        out["coalesced_put_batches"] = put_batches(cl) - b0
        single = core.Cluster(4, mode, pkg.params)
        r2 = np.random.default_rng(23)
        for i in range(12):
            uids.append(single.put(f"rt{i}",
                                   core.FBlob(r2.bytes(scale))))
        out["per_request_put_batches"] = put_batches(single)

        # the daemon: GC epochs every 3 ticks, folds every 2, audits
        # every 3, compactions every 4, foreground puts between ticks
        for i in range(3):
            cl.put(f"key{i}", core.FBlob(rng.bytes(2 * scale)), "tmp")
            cl.remove(f"key{i}", "tmp")
        cl.live("ledger").put(b"acct00", b"dirty")
        cfg = core.RuntimeConfig(tick_budget=8, gc_cycle_ticks=3,
                                 fold_every=2, audit_every=3,
                                 compact_every=4, backoff_queued=2)
        daemon = core.MaintenanceDaemon(cl, runtime=rt, config=cfg)
        ticks = []
        for i in range(10):
            if i % 4 == 1:
                for j in range(3):
                    rt.submit_put(f"tick{i}-{j}",
                                  core.FBlob(rng.bytes(scale)))
            ticks.append(daemon.tick())
            rt.drain()
        out["ticks"] = ticks
        out["daemon_report"] = (None if daemon.collector is None else
                                dataclasses.asdict(daemon.collector.report))

        catt, atts = cl.attest(context=b"parity", secret=SECRET)
        out["attest"] = (catt.root, catt.count, catt.context,
                         [(a.root, a.count, a.context) for a in atts])

        # collections: stop-the-world, then incremental slices
        for i in range(4):
            cl.remove("hot", f"b{i}")
        out["gc_stw"] = dataclasses.asdict(cl.gc())
        for i in range(4, 8):
            cl.remove("hot", f"b{i}")
        col = cl.incremental_gc()
        steps = 0
        while col.active:
            col.step(16)
            steps += 1
        out["gc_incremental"] = dataclasses.asdict(col.report)
        out["gc_steps"] = steps

        # quarantine the fullest node with one corrupt chunk on it
        victim = max(range(4), key=lambda ni: (cl.nodes[ni].stats.chunks,
                                               -ni))
        cid = sorted(cl.nodes[victim].store.iter_cids())[0]
        cl.nodes[victim].store._data[cid] = b"garbage-bytes"
        out["queued"] = cl.quarantine_node(victim, reason="parity")
        out["rerep_steps"] = [cl.rereplicate_step(5) for _ in range(3)]
        out["rerep_total"] = cl.rereplicate()
        out["rerep"] = (cl.rerep_done, cl.rerep_lost, cl.rerep_backlog())
        cl.release_node(victim)
        uids.append(cl.put("after-release", core.FBlob(rng.bytes(scale))))
        out["final"] = cluster_state(cl)
        out["values"] = {k: read_or_miss(core, cl, k)
                         for k in [f"key{i}" for i in range(6)]
                         + ["after-release"]}
    return out


@pytest.mark.parametrize("mode", ["1LP", "2LP"])
@pytest.mark.parametrize("hash_name", ["sha256", "fphash"])
def test_cluster_sequence_parity(hash_name, mode):
    scale = 1000 if hash_name == "sha256" else 400
    with cid_hash(hash_name):
        want = run_sequence(REF, mode, scale)
        got = run_sequence(PORT, mode, scale)
    for key in want:
        assert got[key] == want[key], key
    assert got == want
    # the sequence exercised what it claims to
    assert want["coalesced_put_batches"] < want["per_request_put_batches"]
    assert want["gc_stw"]["swept_chunks"] > 0
    assert want["gc_incremental"]["swept_chunks"] > 0
    assert want["rerep"][0] > 0 and want["rerep"][1] == 1
    assert any(t["gc"] for t in want["ticks"])
    assert any(t["folds"] for t in want["ticks"])
    assert any(t["backoff"] for t in want["ticks"])


# ------------------------------------------------------------ durable carry

def durable_sequence(core, params, root, blob_params=None) -> dict:
    """Seeded durable-cluster operations, then ``sync()`` and a close;
    returns every uid, every node's branch table and the index.  The blob
    is built at the default params unless ``blob_params`` are given."""
    rng = np.random.default_rng(29)
    cl = core.Cluster(3, "2LP", params, durable_root=root,
                      hot_bytes=16 << 10, segment_bytes=32 << 10)
    uids = [cl.put(b"key%02d" % i,
                   core.FMap({b"f%02d" % j: rng.bytes(40) for j in range(8)}))
            for i in range(12)]
    blob_kw = {} if blob_params is None else {"params": blob_params}
    uids.append(cl.put("blob", core.FBlob(rng.bytes(60_000), **blob_kw)))
    cl.fork("blob", "master", "dev")
    b = cl.get("blob", "dev").blob()
    b.replace(10_000, 40, rng.bytes(40))
    b.append(rng.bytes(3000))
    uids.append(cl.put("blob", b, "dev"))
    cl.sync()
    out = {"uids": uids,
           "snapshots": [n.servlet.branches.snapshot() for n in cl.nodes],
           "index": dict(cl.index)}
    for n in cl.nodes:
        n.store.close()
    return out


def read_all(cl) -> dict:
    out = {}
    for i in range(12):
        out[b"key%02d" % i] = list(cl.get(b"key%02d" % i).map().items())
    out["blob"] = cl.get("blob").blob().read()
    out["blob@dev"] = cl.get("blob", "dev").blob().read()
    return out


def tree_bytes(root) -> dict[str, bytes]:
    """Every file under ``root``, by its path relative to ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("hash_name", ["sha256", "fphash"])
def test_durable_cluster_roots_open_in_the_other_package(tmp_path,
                                                         hash_name):
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    with cid_hash(hash_name):
        written = {"ref": durable_sequence(rc, REF.params, roots["ref"]),
                   "port": durable_sequence(pc, PORT.params,
                                            roots["port"])}
        assert written["ref"] == written["port"]
        assert tree_bytes(roots["ref"]) == tree_bytes(roots["port"])
        values = None
        for writer, pkg in (("ref", PORT), ("port", REF)):
            cl = pkg.core.Cluster(3, "2LP", pkg.params,
                                  durable_root=roots[writer], verify=True)
            assert [n.servlet.branches.snapshot() for n in cl.nodes] == \
                written[writer]["snapshots"]
            assert dict(cl.index) == written[writer]["index"]
            got = read_all(cl)
            values = values or got
            assert got == values
            assert cl.audit(sample=10_000, secret=SECRET).ok
            for n in cl.nodes:
                n.store.close()


def segment_chunks(root) -> dict[str, dict[bytes, bytes]]:
    """Each node's segment chunks under ``root``, cid to raw bytes."""
    from repro_torch.storage.durable import SegmentBackend
    out = {}
    for node in sorted(os.listdir(root)):
        seg = SegmentBackend(os.path.join(root, node, "segments"))
        cids = sorted(seg.iter_cids())
        out[node] = dict(zip(cids, seg.get_many(cids)))
        seg.close()
    return out


@pytest.mark.parametrize("hash_name", ["sha256", "fphash"])
def test_durable_cluster_roots_blob_at_cluster_params(tmp_path, hash_name):
    """The sequence with its blob built at the cluster's params, which the
    port splices as separate clusters of edits: the same uids, branch
    tables and index, the same files, each byte-identical but the
    segments, and the same chunks in each node's segments.  The order of
    the records in a segment follows the 16 KiB memory tier's demotions,
    which follow the splice's reads: the reference reads every leaf from
    the first edit to the last, the port the leaves around each cluster."""
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    with cid_hash(hash_name):
        written = {"ref": durable_sequence(rc, REF.params, roots["ref"],
                                           blob_params=REF.params),
                   "port": durable_sequence(pc, PORT.params, roots["port"],
                                            blob_params=PORT.params)}
        assert written["ref"] == written["port"]
        files = {w: tree_bytes(roots[w]) for w in roots}
        assert sorted(files["ref"]) == sorted(files["port"])
        for name, raw in files["ref"].items():
            if "/segments/" not in name:
                assert files["port"][name] == raw, name
        assert segment_chunks(roots["ref"]) == segment_chunks(roots["port"])
