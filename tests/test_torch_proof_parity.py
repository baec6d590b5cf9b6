"""Proofs, the live tier and the ledger of the port against the JAX
package, on the CPU.

The same operations run through both packages and must give byte-equal
membership, absence, lineage and head proofs, attestations, version
records, live-fold roots and uids, ledger block uids and audit reports.
A proof made by either package verifies in the other, and a light client
of either accepts the other's state proofs.  Each comparison runs under
sha256 and, at a few dozen heads, under fphash cids (the reference's
single-string ``fphash`` runs once per Merkle node).  Every check is
exact.

Audit reports: with ``sample`` at least the number of chunks, both
auditors check every chunk, and the findings are compared as sets,
because ``ReplicatedBackend.iter_cids`` lists cids in the order of a
Python set.  Engine audits sample heads from the branch table's ordered
dicts with the same numpy generator, so they are compared whole.

The hash hooks are process-global, and xdist runs a whole file in one
worker, so every test that flips one restores it in ``finally``.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest

import repro.apps.blockchain as ref_bc
import repro.core as rc
import repro.proof as ref_proof
import repro.storage as ref_storage
from repro.core import hashing as ref_hashing
import repro_torch.apps.blockchain as port_bc
import repro_torch.core as pc
import repro_torch.proof as port_proof
import repro_torch.storage as port_storage
from repro_torch.core import hashing
from repro_torch.kernels import ops

REF = types.SimpleNamespace(core=rc, proof=ref_proof, storage=ref_storage,
                            bc=ref_bc, params=rc.ChunkParams(q=8))
PORT = types.SimpleNamespace(core=pc, proof=port_proof,
                             storage=port_storage, bc=port_bc,
                             params=pc.ChunkParams(q=8))
SECRET = b"attest-key"


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@contextlib.contextmanager
def cid_hash(name):
    """sha256 (the default) or fphash cids in both packages."""
    if name == "fphash":
        ref_hashing.use_fphash()
        hashing.use_fphash()
    try:
        yield
    finally:
        ref_hashing.use_sha256()
        hashing.use_sha256()


HASHES = ["sha256", "fphash"]


# ----------------------------------------------------------- scenarios

def build_engine(pkg, keys: int = 6, store=None):
    """Map, Set, List and Blob values with history, a fork, a merge and
    two fork-on-conflict heads; ``keys`` extra small Blob keys."""
    core = pkg.core
    rng = np.random.default_rng(5)
    db = core.ForkBase(store if store is not None
                       else pkg.storage.MemoryBackend(), pkg.params)
    items = {f"k{i:04d}".encode(): rng.bytes(24) for i in range(400)}
    db.put("map", core.FMap(items))
    m = db.get("map").map()
    m.set(b"k0007", b"edited")
    m.delete(b"k0100")
    db.put("map", m)
    db.fork("map", "master", "dev")
    md = db.get("map", "dev").map()
    md.set(b"k0200", b"DEV")
    db.put("map", md, "dev")
    db.merge("map", "master", "dev")
    db.put("set", core.FSet([f"s{i:03d}".encode() for i in range(0, 300, 2)]))
    db.put("list", core.FList([rng.bytes(int(n)) for n in
                               rng.integers(1, 120, 150)]))
    db.put("blob", core.FBlob(rng.bytes(20_000)))
    base = db.get("blob").uid
    for tag in (b"A", b"B"):
        b = db.get("blob", uid=base).blob()
        b.replace(100, 1, tag)
        db.put("blob", b, base_uid=base)
    for i in range(keys):
        db.put(f"h{i:03d}", core.FBlob(b"v%d" % i))
    return db


def proofs_of(db) -> dict:
    """Every proof verb's output as bytes (and the anchors they close
    against)."""
    track = db.track("map", "master")
    head, first = track[0].uid, track[-1].uid
    out = {
        "uids": [o.uid for o in track],
        "roots": [db.get(k).obj.data for k in ("map", "set", "list",
                                               "blob")],
        "member_key": [db.prove_member("map", item_key=k).to_bytes()
                       for k in (b"k0000", b"k0007", b"k0200", b"k0399")],
        "member_pos": [db.prove_member(k, pos=p).to_bytes()
                       for k, p in (("list", 0), ("list", 77), ("set", 3),
                                    ("blob", 12_345))],
        "absent": [db.prove_absence("map", item_key=b"k0100").to_bytes(),
                   db.prove_absence("set", item_key=b"s001").to_bytes(),
                   db.prove_absence("set", item_key=b"zzz").to_bytes()],
        "lineage": db.prove_lineage(head, first).to_bytes(),
        "version": db.prove_version(head),
    }
    att = db.attest(context=b"parity", secret=SECRET)
    out["attestation"] = att.to_bytes()
    heads = []
    for key in db.branches.keys():
        for tag in sorted(db.branches.tagged(key)):
            heads.append(db.prove_head(key, tag).to_bytes())
        aliased = set(db.branches.tagged(key).values())
        for uid in sorted(set(db.branches.untagged(key)) - aliased):
            heads.append(db.prove_head(key, uid=uid).to_bytes())
    out["heads"] = heads
    return out


def verify_all(pkg, p: dict) -> list:
    """Verify ``p`` (from either package) with ``pkg``'s stateless
    verifiers; returns what the verifiers establish."""
    pf = pkg.proof
    got = []
    root_of = dict(zip(("map", "set", "list", "blob"), p["roots"]))
    for raw in p["member_key"]:
        c = pf.verify_member(root_of["map"],
                             pf.MembershipProof.from_bytes(raw))
        got.append((c.mode, c.key, c.value))
    for raw, k in zip(p["member_pos"], ("list", "list", "set", "blob")):
        c = pf.verify_member(root_of[k], raw)
        got.append((c.mode, c.pos, c.value))
    for raw, k in zip(p["absent"], ("map", "set", "set")):
        c = pf.verify_member(root_of[k], raw)
        got.append((c.mode, c.key, c.enclosure))
    chain = pf.verify_lineage(p["uids"][0], p["uids"][-1],
                              pf.LineageProof.from_bytes(p["lineage"]))
    got.append(len(chain))
    got.append(pf.verify_version(p["uids"][0], p["version"]).data)
    for raw in p["heads"]:
        got.append(pf.verify_head(p["attestation"], raw, secret=SECRET))
    return got


# ----------------------------------------------------------- the tests

@pytest.mark.parametrize("h", HASHES)
def test_proofs_and_attestations_are_byte_equal(h):
    with cid_hash(h):
        want = proofs_of(build_engine(REF))
        got = proofs_of(build_engine(PORT))
    assert got == want
    assert len(got["heads"]) == 13 and got["absent"][0] != got["absent"][1]


@pytest.mark.parametrize("h", HASHES)
def test_proofs_verify_across_packages(h):
    with cid_hash(h):
        ref_p = proofs_of(build_engine(REF))
        port_p = proofs_of(build_engine(PORT))
        # each package's verifiers on the other's proofs, both ways
        assert verify_all(PORT, ref_p) == verify_all(REF, ref_p)
        assert verify_all(REF, port_p) == verify_all(PORT, port_p)
        forged = bytearray(port_p["member_key"][1])
        forged[-5] ^= 0x01
        with pytest.raises(ref_proof.InvalidProof):
            ref_proof.verify_member(port_p["roots"][0], bytes(forged))
        with pytest.raises(port_proof.InvalidProof):
            port_proof.verify_member(ref_p["roots"][0], bytes(forged))


def test_full_attestation_and_delta_stats_match():
    """The stateless full build and the engine's delta tree agree in both
    packages, and the delta path does the same hash work in each."""
    out = []
    for pkg in (REF, PORT):
        db = build_engine(pkg, keys=40)
        full = pkg.proof.attest_heads(db.branches, b"c", SECRET)
        first = db.attest()
        for i in range(0, 40, 7):
            db.put(f"h{i:03d}", pkg.core.FBlob(b"again %d" % i))
        delta = db.attest()
        stats = dataclasses.asdict(db._delta().stats)
        out.append((full.to_bytes(), first.root, delta.root,
                    pkg.proof.attest_heads(db.branches).root, stats))
    assert out[0] == out[1]
    assert out[1][2] == out[1][3] and out[1][4]["delta_refreshes"] == 1


@pytest.mark.parametrize("h", HASHES)
def test_state_carried_by_from_state_proves_the_same(h):
    """A reference engine's chunks and heads served by the port (and the
    port's back by a reference engine) give the same attestation root
    and the same proofs."""
    with cid_hash(h):
        ref_db = build_engine(REF)
        port_db = pc.from_state(dict(ref_db.store._data),
                                ref_db.branches.snapshot(),
                                params=PORT.params)
        want = proofs_of(ref_db)
        assert proofs_of(port_db) == want
        port_db.put("fresh", pc.FBlob(b"written by the port" * 50))
        back = rc.ForkBase(params=REF.params)
        cids = list(port_db.store._data)
        back.store.put_many([port_db.store._data[c] for c in cids], cids)
        back.branches.restore(port_db.branches.snapshot())
        assert proofs_of(back) == proofs_of(port_db)


def live_epochs(pkg) -> list:
    """Live puts, deletes, reads through the archive, folds, an
    auto-fold, a fork of a dirty head and commit_epoch with attest."""
    core = pkg.core
    rng = np.random.default_rng(9)
    db = core.ForkBase(pkg.storage.MemoryBackend(), pkg.params)
    t = db.live(b"state")
    out = []
    for epoch in range(4):
        for i in rng.integers(0, 1500, 300):
            t.put(b"key%05d" % int(i), rng.bytes(int(rng.integers(1, 90))))
        for i in rng.integers(0, 1500, 30):
            t.delete(b"key%05d" % int(i))
        out.append(t.get(b"key%05d" % int(rng.integers(0, 1500))))
        rep = t.fold(context=b"epoch %d" % epoch)
        out.append((rep.uid, rep.folded_keys, rep.deleted_keys,
                    db.get(b"state").obj.data))
    t.put(b"key99999", b"dirty at fork")
    db.fork(b"state", "master", "side")          # folds the dirty head
    side = db.live(b"state", "side")
    side.put(b"key00001", b"side")
    small = db.live(b"small", policy=pkg.live.EpochPolicy(max_dirty_keys=50))
    for i in range(120):                          # two auto-folds
        small.put(b"s%03d" % i, b"x" * (i % 7))
    ep = db.commit_epoch(context=b"close", attest=True, secret=SECRET)
    out.append(([(f.key, f.branch, f.uid, f.folded_keys) for f in ep.folds],
                ep.attestation.to_bytes(), small.stats.auto_folds))
    out.append(db.prove_member(b"state", "side",
                               item_key=b"key00001").to_bytes())
    return out


def test_live_folds_give_the_same_roots_and_uids():
    import repro.live as ref_live
    import repro_torch.live as port_live
    want = live_epochs(types.SimpleNamespace(**vars(REF), live=ref_live))
    got = live_epochs(types.SimpleNamespace(**vars(PORT), live=port_live))
    assert got == want
    assert got[-2][2] == 2


def ledger_run(pkg, live: bool):
    """blockchain_ops' shape at a small size: seeded accounts, then
    blocks of seeded random writes.  The archival ledger keeps one head
    per account, so it stays at a few dozen heads (its attestation runs
    the reference's single-string fphash once per Merkle node)."""
    rng = np.random.default_rng(3)
    led = pkg.bc.ForkBaseLedger(pkg.core.ForkBase(
        pkg.storage.MemoryBackend(), pkg.params), live=live)
    accounts = 300 if live else 40
    uids = []
    for i in range(accounts):
        led.write("kv", f"key{i}", rng.bytes(64))
    uids.append(led.commit())
    for _ in range(4):
        for j in rng.integers(0, accounts, 12 if not live else 40):
            led.write("kv", f"key{int(j)}", rng.bytes(64))
        led.write("bank", "alice", rng.bytes(8))
        uids.append(led.commit())
    return led, uids


def _cross(proof, cls):
    """A state proof carried to the other package: its byte fields."""
    return cls(**dataclasses.asdict(proof))


@pytest.mark.parametrize("h", HASHES)
@pytest.mark.parametrize("live", [False, True], ids=["archival", "live"])
def test_ledger_blocks_and_light_clients_across_packages(h, live):
    with cid_hash(h):
        ref_led, ref_uids = ledger_run(REF, live)
        port_led, port_uids = ledger_run(PORT, live)
        assert port_uids == ref_uids
        head = port_led.db.get("chain").uid
        ref_client = ref_bc.LightClient(head)
        port_client = port_bc.LightClient(head)
        for key, height in (("key7", None), ("key23", 2), ("alice", 1)):
            contract = "bank" if key == "alice" else "kv"
            if live:
                pp = port_led.prove_state_flat(contract, key, height)
                rp = ref_led.prove_state_flat(contract, key, height)
                assert dataclasses.asdict(pp) == dataclasses.asdict(rp)
                want = port_client.verify_state_flat(pp, contract, key)
                assert ref_client.verify_state_flat(
                    _cross(pp, ref_bc.FlatStateProof), contract, key) == want
                assert port_client.verify_state_flat(
                    _cross(rp, port_bc.FlatStateProof), contract, key) == want
            else:
                pp = port_led.prove_state(contract, key, height)
                rp = ref_led.prove_state(contract, key, height)
                assert dataclasses.asdict(pp) == dataclasses.asdict(rp)
                want = port_client.verify_state(pp, contract, key)
                assert ref_client.verify_state(
                    _cross(pp, ref_bc.StateProof), contract, key) == want
                assert port_client.verify_state(
                    _cross(rp, port_bc.StateProof), contract, key) == want
            assert want[1] == port_led.block_scan(
                port_led.height - 1 if height is None else height)[
                    (contract, key)]
        for height in (0, 3):
            lp = port_led.prove_block(height)
            assert lp.to_bytes() == ref_led.prove_block(height).to_bytes()
            assert ref_client.verify_block(
                ref_proof.LineageProof.from_bytes(lp.to_bytes()),
                port_led.block_uid(height)) == 4 - height
        att = port_led.attest(secret=SECRET)
        hp = port_led.prove_chain_head()
        assert att.to_bytes() == ref_led.attest(secret=SECRET).to_bytes()
        assert ref_client.refresh_head(
            ref_proof.Attestation.from_bytes(att.to_bytes()),
            ref_proof.HeadProof.from_bytes(hp.to_bytes()),
            secret=SECRET) == head


def _findings(rep):
    return sorted((f.node, f.kind, f.detail, f.cid) for f in rep.findings)


def _counts(rep):
    return (rep.chunks_checked, rep.copies_checked, rep.heads_checked,
            rep.proofs_verified)


def replica_audits(pkg):
    """A 3-way replicated ledger, clean and then with one copy corrupted,
    one lost and one head meta chunk forged on a verifying engine."""
    rng = np.random.default_rng(4)
    rb = pkg.storage.ReplicatedBackend(
        [pkg.storage.MemoryBackend() for _ in range(3)], k=3)
    led = pkg.bc.ForkBaseLedger(pkg.core.ForkBase(rb, pkg.params))
    for i in range(20):
        led.write("kv", f"key{i}", rng.bytes(64))
    led.commit()
    for j in rng.integers(0, 20, 6):
        led.write("kv", f"key{int(j)}", rng.bytes(64))
    led.commit()
    out = []
    auditor = pkg.proof.Auditor(sample=len(rb), seed=1)
    rep = auditor.audit_replicas(rb)
    out.append((_counts(rep), _findings(rep)))
    rep = led.db.audit(sample=64, secret=SECRET)
    out.append((_counts(rep), [(f.node, f.kind, f.cid)
                               for f in rep.findings]))
    cids = sorted(rb.iter_cids())
    bad, lost = cids[7], cids[11]
    raw = rb.stores[1]._data[bad]
    rb.stores[1]._data[bad] = raw[:-1] + bytes([raw[-1] ^ 0x5A])
    del rb.stores[2]._data[lost]
    rep = pkg.proof.Auditor(sample=len(rb), seed=1).audit_replicas(rb)
    out.append((_counts(rep), _findings(rep)))
    return out


@pytest.mark.parametrize("h", HASHES)
def test_audit_reports_are_equal(h):
    with cid_hash(h):
        want = replica_audits(REF)
        got = replica_audits(PORT)
    assert got == want
    assert got[0][1] == [] and got[1][1] == []
    assert [f[:2] for f in got[2][1]] == [("replica1", "corrupt"),
                                          ("replica2", "missing")]


def test_engine_audit_of_a_forged_head_is_equal():
    out = []
    for pkg in (REF, PORT):
        store = pkg.storage.MemoryBackend(verify=True)
        db = build_engine(pkg, store=store)
        uid = db.get("set").uid
        raw = store._data[uid]
        store._data[uid] = raw[:-1] + bytes([raw[-1] ^ 0xFF])
        rep = db.audit(sample=64, seed=2, secret=SECRET)
        out.append((_counts(rep), [(f.node, f.kind, f.cid)
                                   for f in rep.findings]))
    assert out[0] == out[1]
    assert [f[1] for f in out[1][1]] == ["corrupt"]
