"""The proof subsystem of the port (repro_torch.proof), on the CPU:
membership and absence proofs, lineage proofs, head attestations, the
replica and engine audits, the light client, forgery sweeps and the wire
format.

The JAX package's ``tests/test_proof.py`` with its cluster tests (the
per-servlet attestation, the cluster audit of a corrupt node, of a
verify-enabled node and of a routing divergence), plus
``tests/test_api.py``'s ``test_verify_lineage``."""
import dataclasses

import numpy as np
import pytest

from repro_torch.core import (Cluster, FBlob, FList, FMap, FSet, ForkBase,
                              FString)
from repro_torch.core import chunk as ck
from repro_torch.core.chunker import ChunkParams
from repro_torch.core.postree import POSTree
from repro_torch.kernels import ops
from repro_torch.proof import (Attestation, InvalidProof, LineageProof,
                               MembershipProof, prove_absence, prove_head,
                               prove_lineage, prove_member, verify_head,
                               verify_lineage, verify_member,
                               verify_member_many, verify_version)
from repro_torch.storage import (MemoryBackend, ReplicatedBackend,
                                 TamperedChunk)

PARAMS = ChunkParams(q=8)           # 256 B chunks: multi-level test trees


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@pytest.fixture
def db():
    return ForkBase(MemoryBackend(), PARAMS)


def _tree(db, key):
    obj = db.get(key).obj
    return obj.data, POSTree.from_root(db.store, obj.type, obj.data,
                                       PARAMS)


def _mutations(raw, step=1):
    for i in range(0, len(raw), step):
        yield raw[:i] + bytes([raw[i] ^ 0x5A]) + raw[i + 1:]


def _flip_tail(raw):
    return raw[:-1] + bytes([raw[-1] ^ 0xFF])


# ------------------------------------------------------------- membership

def test_member_by_key_map(db, rng):
    m = {b"k%05d" % i: rng.bytes(20) for i in range(500)}
    db.put("m", FMap(m))
    root, tree = _tree(db, "m")
    assert tree.height > 1                      # a real multi-level tree
    proof = prove_member(tree, key=b"k00321")
    claim = verify_member(root, proof.to_bytes())
    assert claim.key == b"k00321" and claim.value == m[b"k00321"]


def test_member_by_pos_all_kinds(db, rng):
    data = rng.bytes(9000)
    db.put("b", FBlob(data))
    els = [b"el-%05d" % i for i in range(700)]
    db.put("l", FList(els))
    db.put("s", FSet(els))
    db.put("m", FMap({e: e[::-1] for e in els}))
    for key, want in [("b", lambda p: data[p:p + 1]),
                      ("l", lambda p: els[p]),
                      ("s", lambda p: sorted(els)[p]),
                      ("m", lambda p: ck.pack_kv(sorted(els)[p],
                                                 sorted(els)[p][::-1]))]:
        root, tree = _tree(db, key)
        for pos in (0, 17, tree.total_count - 1):
            claim = verify_member(root, prove_member(tree, pos=pos))
            assert claim.value == want(pos), key


def test_absence_with_enclosure(db, rng):
    keys = [b"k%05d" % i for i in range(0, 1000, 2)]     # evens only
    db.put("m", FMap({k: b"v" for k in keys}))
    root, tree = _tree(db, "m")
    claim = verify_member(root, prove_absence(tree, b"k00301").to_bytes())
    assert claim.enclosure == (b"k00300", b"k00302")
    # off both ends
    lo = verify_member(root, prove_absence(tree, b"a"))
    assert lo.enclosure[0] is None
    hi = verify_member(root, prove_absence(tree, b"z"))
    assert hi.enclosure[1] is None
    # present key cannot be proven absent
    with pytest.raises(KeyError):
        prove_absence(tree, b"k00300")


def test_verify_needs_matching_root(db, rng):
    db.put("a", FMap({b"x%03d" % i: b"1" for i in range(300)}))
    db.put("b", FMap({b"x%03d" % i: b"2" for i in range(300)}))
    root_a, tree_a = _tree(db, "a")
    root_b, _ = _tree(db, "b")
    proof = prove_member(tree_a, key=b"x007")
    verify_member(root_a, proof)
    with pytest.raises(InvalidProof):
        verify_member(root_b, proof)            # wrong trust anchor


def test_verify_member_many_batches_and_isolates_failures(db, rng):
    db.put("m", FMap({b"k%04d" % i: rng.bytes(8) for i in range(400)}))
    root, tree = _tree(db, "m")
    items = [(root, prove_member(tree, pos=i * 7)) for i in range(30)]
    claims = verify_member_many(items)
    assert len(claims) == 30
    bad = dataclasses.replace(items[3][1], value=b"forged")
    mixed = items[:3] + [(root, bad)] + items[4:]
    res = verify_member_many(mixed, strict=False)
    assert isinstance(res[3], InvalidProof)
    assert sum(1 for r in res if isinstance(r, InvalidProof)) == 1
    with pytest.raises(InvalidProof):
        verify_member_many(mixed)


# ---------------------------------------------------------------- lineage

def test_lineage_proof_and_depth(db, rng):
    uids = [db.put("k", FBlob(b"v%d" % i)) for i in range(6)]
    proof = prove_lineage(db.store, uids[-1], uids[1])
    objs = verify_lineage(uids[-1], uids[1], proof.to_bytes())
    assert len(objs) - 1 == 4                   # derivation distance
    assert [o.uid for o in objs] == list(reversed(uids[1:]))
    assert objs[-1].depth == 1                  # authenticated depth field
    # self-proof: distance 0
    assert len(verify_lineage(uids[0], uids[0],
                              prove_lineage(db.store, uids[0],
                                            uids[0]))) == 1


def test_lineage_through_merge(db, rng):
    base = {b"k%02d" % i: b"v" for i in range(40)}
    db.put("k", FMap(base))
    anchor = db.get("k").uid
    db.fork("k", "master", "side")
    m1 = db.get("k", "side").map()
    m1.set(b"side-only", b"1")
    db.put("k", m1, "side")
    m2 = db.get("k").map()
    m2.set(b"master-only", b"2")
    db.put("k", m2)
    merged = db.merge("k", "master", "side")
    proof = prove_lineage(db.store, merged, anchor)
    assert len(verify_lineage(merged, anchor, proof)) >= 2


def test_spliced_history_rejected(db, rng):
    """A proof from a different branch's history cannot authenticate
    against this head, and non-ancestors cannot be proven at all."""
    db.put("k", FBlob(b"base"))
    db.fork("k", "master", "evil")
    db.put("k", FBlob(b"good"))
    db.put("k", FBlob(b"forged"), "evil")
    good, evil = db.get("k").uid, db.get("k", "evil").uid
    with pytest.raises(KeyError):
        prove_lineage(db.store, good, evil)     # not an ancestor
    proof = prove_lineage(db.store, evil, db.get("k").obj.bases[0])
    with pytest.raises(InvalidProof):
        verify_lineage(good, db.get("k").obj.bases[0], proof)


def test_verify_version_binds_uid(db, rng):
    uid = db.put("k", FMap({b"a": b"1"}))
    raw = db.prove_version(uid)
    obj = verify_version(uid, raw)
    assert obj.uid == uid and obj.type == ck.MAP
    with pytest.raises(InvalidProof):
        verify_version(uid, raw[:-1] + bytes([raw[-1] ^ 1]))


# ------------------------------------------------------------ attestation

def test_attestation_commits_every_head(db, rng):
    for i in range(7):
        db.put("k%d" % i, FBlob(b"v%d" % i))
    db.fork("k0", "master", "feature")
    att = db.attest(context=b"epoch-1", secret=b"hmac-key")
    att2 = Attestation.from_bytes(att.to_bytes())
    for key, tag in [(b"k0", "master"), (b"k0", "feature"),
                     (b"k5", "master")]:
        proof = db.prove_head(key, tag)
        k, t, uid = verify_head(att2, proof.to_bytes(), secret=b"hmac-key")
        assert (k, t) == (key, tag)
        assert uid == db.branches.head(key, tag)


def test_attestation_covers_untagged_heads(db, rng):
    base = db.put("k", FBlob(b"v0"))
    db.put("k", FBlob(b"v1"), base_uid=base)    # FoC: untagged head
    foc = db.list_untagged_branches("k")[0]
    att = db.attest()
    _, tag, uid = verify_head(att, db.prove_head("k", uid=foc))
    assert uid == foc


def test_stale_attestation_rejects_new_head(db, rng):
    db.put("k", FBlob(b"v0"))
    att = db.attest(secret=b"s")
    db.put("k", FBlob(b"v1"))                   # head moves on
    with pytest.raises(InvalidProof):
        verify_head(att, db.prove_head("k", "master"), secret=b"s")


def test_wrong_secret_rejected(db, rng):
    db.put("k", FBlob(b"v"))
    att = db.attest(secret=b"right")
    proof = db.prove_head("k", "master")
    verify_head(att, proof, secret=b"right")
    with pytest.raises(InvalidProof):
        verify_head(att, proof, secret=b"wrong")


def test_cluster_attestation_per_servlet():
    cl = Cluster(3)
    for i in range(8):
        cl.put("key%d" % i, FBlob(b"v%d" % i))
    catt, atts = cl.attest(context=b"e", secret=b"s")
    assert catt.count == 3 and len(atts) == 3
    assert sum(a.count for a in atts) == 8
    # drill into one servlet: its attestation commits its keys
    for ni, nd in enumerate(cl.nodes):
        for key in nd.servlet.branches.keys():
            proof = prove_head(nd.servlet.branches, key, "master")
            verify_head(atts[ni], proof, secret=b"s")


# -------------------------------------------------- forged-proof rejection
#
# Soundness property: mutating any proof byte either fails verification
# or shifts the proof onto a DIFFERENT claim that is still TRUE of the
# underlying data (e.g. the absence of some other genuinely absent key).
# No mutation may ever make a false statement verify.

def _assert_all_mutations_rejected(verify, raw, step=1):
    for mut in _mutations(raw, step):
        with pytest.raises(InvalidProof):
            verify(mut)


def _assert_mutations_sound(verify, raw, orig_claim, truth, step=1):
    key_of = lambda c: (c.mode, c.pos, c.key, c.value)   # noqa: E731
    for mut in _mutations(raw, step):
        try:
            c = verify(mut)
        except InvalidProof:
            continue
        assert key_of(c) != key_of(orig_claim), "same claim, forged bytes"
        truth(c)


def test_forged_membership_rejected_exhaustive(db, rng):
    m = {b"k%04d" % i: rng.bytes(12) for i in range(300)}
    db.put("m", FMap(m))
    root, tree = _tree(db, "m")

    def truth(c):
        if c.mode == 2:                    # member-by-key: must be real
            assert m.get(c.key) == c.value
        elif c.mode == 1:                  # member-by-pos
            k, v = sorted(m.items())[c.pos]
            assert ck.pack_kv(k, v) == c.value
        else:                              # absence: must be truly absent
            assert c.key not in m
    for proof in (prove_member(tree, key=b"k0123"),
                  prove_member(tree, pos=77),
                  prove_absence(tree, b"k0123x")):
        orig = verify_member(root, proof.to_bytes())
        _assert_mutations_sound(lambda mb: verify_member(root, mb),
                                proof.to_bytes(), orig, truth)


def test_forged_lineage_rejected_exhaustive(db, rng):
    uids = [db.put("k", FBlob(b"v%d" % i)) for i in range(4)]
    raw = prove_lineage(db.store, uids[-1], uids[0]).to_bytes()
    _assert_all_mutations_rejected(
        lambda m: verify_lineage(uids[-1], uids[0], m), raw)


def test_forged_attestation_rejected_exhaustive(db, rng):
    for i in range(5):
        db.put("k%d" % i, FBlob(b"v"))
    att_raw = db.attest(context=b"ctx", secret=b"s").to_bytes()
    hp_raw = db.prove_head(b"k2", "master").to_bytes()
    verify_head(att_raw, hp_raw, secret=b"s")
    _assert_all_mutations_rejected(
        lambda m: verify_head(m, hp_raw, secret=b"s"), att_raw)
    _assert_all_mutations_rejected(
        lambda m: verify_head(att_raw, m, secret=b"s"), hp_raw)


# ------------------------------------------------- hypothesis properties

def test_proof_roundtrip_property(db):
    """Round-trip for every chunkable type + forged rejection, under
    randomized contents/positions (hypothesis)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(data=st.data(), seed=st.integers(0, 2**31 - 1),
           n=st.integers(1, 120))
    def prop(data, seed, n):
        rng = np.random.default_rng(seed)
        store = MemoryBackend()
        kind = data.draw(st.sampled_from(["blob", "list", "set", "map"]))
        if kind == "blob":
            payload = rng.bytes(n * 37 + 1)
            tree = POSTree.build_bytes(store, payload, PARAMS)
        else:
            els = sorted({b"e%06d-%d" % (i, seed % 97)
                          for i in range(n)})
            if kind == "map":
                tree = POSTree.build_elements(
                    store, ck.MAP, [ck.pack_kv(e, e[::-1]) for e in els],
                    keys=els, params=PARAMS)
            elif kind == "set":
                tree = POSTree.build_elements(
                    store, ck.SET, [ck.pack_lv(e) for e in els],
                    keys=els, params=PARAMS)
            else:
                tree = POSTree.build_elements(
                    store, ck.LIST, [ck.pack_lv(e) for e in els],
                    params=PARAMS)
        root = tree.root_cid
        pos = data.draw(st.integers(0, tree.total_count - 1))
        proof = prove_member(tree, pos=pos)
        claim = verify_member(root, proof.to_bytes())
        assert claim.pos == pos

        def item_at(p):
            if kind == "blob":
                return payload[p:p + 1]
            if kind == "map":
                return ck.pack_kv(els[p], els[p][::-1])
            return els[p]
        assert claim.value == item_at(pos)
        # soundness under mutation: flip one random byte — the proof
        # must fail, or prove a different still-true positional claim
        raw = proof.to_bytes()
        i = data.draw(st.integers(0, len(raw) - 1))
        mut = raw[:i] + bytes([raw[i] ^ data.draw(
            st.integers(1, 255))]) + raw[i + 1:]
        try:
            c = verify_member(root, mut)
        except InvalidProof:
            c = None
        if c is not None:
            assert (c.mode, c.pos, c.value) != (claim.mode, pos,
                                                claim.value)
            if c.mode == 1:
                assert c.value == item_at(c.pos)

    prop()


def test_lineage_and_attest_forgery_property(db):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    uids = [db.put("k", FBlob(b"version-%d" % i)) for i in range(5)]
    lin_raw = prove_lineage(db.store, uids[-1], uids[0]).to_bytes()
    att_raw = db.attest(secret=b"s").to_bytes()
    hp_raw = db.prove_head(b"k", "master").to_bytes()

    @settings(max_examples=60, deadline=None)
    @given(which=st.sampled_from(["lineage", "attestation", "head"]),
           data=st.data())
    def prop(which, data):
        raw = {"lineage": lin_raw, "attestation": att_raw,
               "head": hp_raw}[which]
        i = data.draw(st.integers(0, len(raw) - 1))
        x = data.draw(st.integers(1, 255))
        mut = raw[:i] + bytes([raw[i] ^ x]) + raw[i + 1:]
        with pytest.raises(InvalidProof):
            if which == "lineage":
                verify_lineage(uids[-1], uids[0], mut)
            elif which == "attestation":
                verify_head(mut, hp_raw, secret=b"s")
            else:
                verify_head(att_raw, mut, secret=b"s")

    prop()


# ------------------------------------------------------------ verify-on-get

def test_verify_on_get_counts_and_catches(rng):
    store = MemoryBackend()
    db = ForkBase(store, PARAMS, verify_get=True)
    uid = db.put("k", FBlob(rng.bytes(2000)))
    db.get("k")
    assert store.stats.verifies == 1 and store.stats.verify_failures == 0
    store._data[uid] = _flip_tail(store._data[uid])
    with pytest.raises(TamperedChunk):
        db.get("k")
    assert store.stats.verify_failures == 1
    # per-call override wins over the engine default
    db2 = ForkBase(MemoryBackend(), PARAMS)
    u2 = db2.put("k", FBlob(b"x"))
    db2.store._data[u2] = _flip_tail(db2.store._data[u2])
    db2.get("k")                                # default: unchecked
    with pytest.raises(TamperedChunk):
        db2.get("k", verify=True)


# ----------------------------------------------------------------- auditor

def test_replica_audit_reports_offending_node(rng):
    rb = ReplicatedBackend([MemoryBackend() for _ in range(3)], k=2)
    db = ForkBase(rb, PARAMS)
    db.put("k", FBlob(rng.bytes(30_000)))
    assert rb.audit(sample=1000).ok
    cid = sorted(rb.iter_cids())[3]
    victim = None
    for si, s in enumerate(rb.stores):
        if s.has(cid):
            raw = s._data[cid]
            s._data[cid] = raw[:-1] + bytes([raw[-1] ^ 1])
            victim = si
            break
    rep = rb.audit(sample=1000)
    assert not rep.ok
    assert any(f.kind == "corrupt" and f.node == f"replica{victim}"
               and f.cid == cid for f in rep.findings)


def test_replica_audit_reports_missing_copy(rng):
    rb = ReplicatedBackend([MemoryBackend() for _ in range(3)], k=2)
    rb.put_many([ck.encode_chunk(3, rng.bytes(100) + bytes([i]))
                 for i in range(20)])
    cid = sorted(rb.iter_cids())[0]
    for s in rb.stores:                          # drop ONE ring copy
        if s.has(cid):
            del s._data[cid]
            break
    rep = rb.audit(sample=1000)
    assert any(f.kind == "missing" and f.cid == cid for f in rep.findings)


def test_engine_audit_end_to_end(db, rng):
    for i in range(4):
        db.put("k%d" % i,
               FMap({b"e%03d" % j: rng.bytes(16) for j in range(80)}))
        db.put("k%d" % i,
               FMap({b"e%03d" % j: rng.bytes(16) for j in range(80)}))
    rep = db.audit(secret=b"s")
    assert rep.ok and rep.proofs_verified > 0 and rep.heads_checked == 4


def test_cluster_audit_catches_node_corruption(rng):
    cl = Cluster(3, params=PARAMS)
    for i in range(6):
        cl.put("key%d" % i, FBlob(rng.bytes(8000)))
    assert cl.audit(sample=10_000, secret=b"s").ok
    nd = cl.nodes[2]
    cid = sorted(nd.store._data)[1]
    raw = nd.store._data[cid]
    nd.store._data[cid] = raw[:-1] + bytes([raw[-1] ^ 0xFF])
    rep = cl.audit(sample=10_000, secret=b"s")
    assert not rep.ok
    assert any(f.node == "node2" for f in rep.findings)


def test_cluster_audit_detects_routing_divergence(rng):
    cl = Cluster(3, params=PARAMS)
    cl.put("key", FBlob(b"v"))
    home = cl._home_index("key")
    rogue = cl.nodes[(home + 1) % 3].servlet
    rogue.branches.set_head(b"key", "master", cl.get("key").uid)
    rep = cl.audit(sample=100)
    assert any(f.kind == "diverged" for f in rep.findings)


def test_audit_reports_instead_of_raising_on_verify_store(rng):
    """A verify-enabled store raises TamperedChunk on Get; the auditor
    must absorb that into a 'corrupt' finding, not crash."""
    store = MemoryBackend(verify=True)
    db = ForkBase(store, PARAMS)
    uid = db.put("k", FBlob(rng.bytes(4000)))
    store._data[uid] = _flip_tail(store._data[uid])
    rep = db.audit(secret=b"s")
    assert not rep.ok
    assert any(f.kind == "corrupt" and f.cid == uid for f in rep.findings)
    # replicas: same containment
    rb = ReplicatedBackend([MemoryBackend(verify=True) for _ in range(3)],
                           k=2)
    cid = rb.put(ck.encode_chunk(3, rng.bytes(500)))
    for s in rb.stores:
        if s.has(cid):
            s._data[cid] = _flip_tail(s._data[cid])
    rep = rb.audit(sample=10)
    assert not rep.ok and all(f.kind == "corrupt" for f in rep.findings)
    # cluster: a verify-enabled node with a corrupt chunk
    cl = Cluster(2, params=PARAMS, verify=True)
    cl.put("key", FBlob(rng.bytes(4000)))
    nd = cl.nodes[0] if cl.nodes[0].store._data else cl.nodes[1]
    c0 = sorted(nd.store._data)[0]
    nd.store._data[c0] = _flip_tail(nd.store._data[c0])
    rep = cl.audit(sample=10_000)
    assert not rep.ok
    assert any(f.kind == "corrupt" for f in rep.findings)


def test_light_client_rejects_empty_lineage(rng):
    from repro_torch.apps.blockchain import ForkBaseLedger, LightClient
    led = ForkBaseLedger()
    led.write("c", "k", b"v")
    led.commit()
    lc = LightClient(led.db.get("chain").uid)
    sp = led.prove_state("c", "k")
    empty = bytes([0xFB, 4]) + b"\x00\x00"        # n=0 lineage, parses
    forged = dataclasses.replace(sp, lineage=empty)
    with pytest.raises(InvalidProof):
        lc.verify_state(forged, "c", "k")


def test_light_client_rejects_forged_empty_value(rng):
    """A server cannot present a non-empty state as empty by dropping
    the value leaf proofs; a genuinely empty state still verifies."""
    from repro_torch.apps.blockchain import ForkBaseLedger, LightClient
    led = ForkBaseLedger()
    led.write("bank", "alice", b"100 coins")
    led.write("bank", "emptied", b"")
    led.commit()
    lc = LightClient(led.db.get("chain").uid)
    sp = led.prove_state("bank", "alice")
    forged = dataclasses.replace(sp, value=b"", value_proofs=())
    with pytest.raises(InvalidProof):
        lc.verify_state(forged, "bank", "alice")
    _, val = lc.verify_state(led.prove_state("bank", "emptied"),
                             "bank", "emptied")
    assert val == b""


def test_make_backend_sharded_honors_verify(rng):
    from repro_torch.storage import make_backend
    be = make_backend("sharded", shards=2, verify=True)
    cid = be.put(ck.encode_chunk(3, rng.bytes(300)))
    shard = next(s for s in be.shards if s.has(cid))
    shard._data[cid] = _flip_tail(shard._data[cid])
    with pytest.raises(TamperedChunk):
        be.get(cid)


def test_prove_head_defaults_to_master(db, rng):
    db.put("k", FBlob(b"v"))
    att = db.attest(secret=b"s")
    _, tag, uid = verify_head(att, db.prove_head("k"), secret=b"s")
    assert tag == "master" and uid == db.branches.head(b"k", "master")


# ------------------------------------------------------------ light client

def test_light_client_blockchain(rng):
    from repro_torch.apps.blockchain import ForkBaseLedger, LightClient
    led = ForkBaseLedger()
    for h in range(3):
        led.write("bank", "alice", rng.bytes(150) + b"@h%d" % h)
        led.write("bank", "bob", rng.bytes(150))
        led.commit()
    lc = LightClient(led.db.get("chain").uid)
    assert lc.verify_block(led.prove_block(0), led.block_uid(0)) == 2
    for h in (2, 0):
        sp = led.prove_state("bank", "alice", height=h)
        dist, val = lc.verify_state(sp, "bank", "alice")
        assert dist == 2 - h and val.endswith(b"@h%d" % h)
    # a proof for bob cannot masquerade as alice's state
    sp = led.prove_state("bank", "bob")
    with pytest.raises(InvalidProof):
        lc.verify_state(sp, "bank", "alice")
    # forged value bytes are rejected
    sp = led.prove_state("bank", "alice")
    forged = dataclasses.replace(sp, value=sp.value[:-1] + b"\x00")
    with pytest.raises(InvalidProof):
        lc.verify_state(forged, "bank", "alice")


# ------------------------------------------------------------- proof sizes

def test_proof_size_grows_logarithmically(rng):
    sizes = []
    for n in (200, 2000, 20000):
        store = MemoryBackend()
        els = [b"k%07d" % i for i in range(n)]
        tree = POSTree.build_elements(
            store, ck.SET, [ck.pack_lv(e) for e in els], keys=els,
            params=PARAMS)
        proofs = [prove_member(tree, pos=int(p)).size
                  for p in rng.integers(0, n, 16)]
        sizes.append(sum(proofs) / len(proofs))
    # 100x the elements must cost far less than 100x the proof bytes
    assert sizes[2] < sizes[0] * 8


def test_member_proof_wire_roundtrip(db, rng):
    db.put("m", FMap({b"k%03d" % i: rng.bytes(5) for i in range(200)}))
    _, tree = _tree(db, "m")
    p = prove_member(tree, key=b"k055")
    assert MembershipProof.from_bytes(p.to_bytes()) == p
    lp = LineageProof((db.prove_version(db.get("m").uid),))
    assert LineageProof.from_bytes(lp.to_bytes()) == lp


# ---------------------------------------------------- tests/test_api.py

def test_verify_lineage(db):
    u1 = db.put("k", FString(b"a"))
    u2 = db.put("k", FString(b"b"))
    u3 = db.put("k", FString(b"c"))
    assert db.verify_lineage(u3, u1)
    assert not db.verify_lineage(u1, u3)
