"""Delta attestations, the GC epoch handshake and proof caching of the
port (repro_torch.proof.delta), on the CPU.

Covers:
  * delta-maintained attestation roots are bit-identical to full
    rebuilds under randomized branch-table churn, with O(path) hash
    work after single-head updates;
  * forge sweep: every single-bit flip of a delta-maintained root must
    fail verify_head;
  * malformed committed entries surface as InvalidProof, never raw
    struct errors (decode_entry framing validation);
  * the attest-vs-sweep orphaning race: heads committed by an
    attestation stay provable through the next collection (EpochFence)
    and are rescued from a live sweep (attest_fence);
  * per-root proof cache + persistent verify memo;
  * AuditDaemon: exponential backoff per clean node, immediate
    re-audit + quarantine on a finding, release.

The JAX package's ``tests/test_proof_delta.py``, its cluster and
AuditDaemon tests included."""
import pytest

from repro_torch.core import Cluster, FBlob, FMap, ForkBase
from repro_torch.core.chunker import ChunkParams
from repro_torch.proof import (InvalidProof, VerifyMemo, attest_heads,
                               attestation_epoch, verify_head,
                               verify_member_many)
from repro_torch.proof.attest import (encode_entry, entry_leaves, merkle_root,
                                      prove_entry)
from repro_torch.proof.delta import DeltaAttestor
from repro_torch.kernels import ops
from repro_torch.storage import MemoryBackend

PARAMS = ChunkParams(q=8)


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


@pytest.fixture
def db():
    return ForkBase(MemoryBackend(), PARAMS)


# ---------------------------------------------------------- delta == full

def test_delta_root_matches_full_rebuild_under_churn(db, rng):
    """Random put/fork/remove/rename/FoC churn: after every mutation the
    delta-maintained root must equal a from-scratch attest_heads."""
    da = DeltaAttestor(db.branches)
    keys = [b"k%02d" % i for i in range(6)]
    for _step in range(150):
        op = int(rng.integers(0, 100))
        k = keys[int(rng.integers(0, len(keys)))]
        tags = sorted(db.branches.tagged(k))
        try:
            if op < 45:
                db.put(k, FBlob(rng.bytes(40)),
                       tags[int(rng.integers(0, len(tags)))]
                       if tags and op < 30 else "master")
            elif op < 60 and tags:
                db.fork(k, tags[int(rng.integers(0, len(tags)))],
                        "b%d" % int(rng.integers(0, 5)))
            elif op < 75 and tags:
                db.remove(k, tags[int(rng.integers(0, len(tags)))])
            elif op < 85 and tags:
                db.branches.rename(k, tags[int(rng.integers(0, len(tags)))],
                                   "r%d" % int(rng.integers(0, 5)))
            else:
                h = db.branches.head(k, "master")
                if h is not None:
                    db.put(k, FBlob(rng.bytes(30)), base_uid=h)  # FoC
        except (KeyError, ValueError):
            pass
        want = attest_heads(db.branches)
        got = da.attest()
        assert got.root == want.root and got.count == want.count
    assert da.stats.full_rebuilds == 1          # only the first attest
    assert da.stats.delta_refreshes > 50


def test_delta_update_rehashes_one_path(db):
    """k single-head updates cost O(k log n) hashes, not O(n)."""
    n = 256
    for i in range(n):
        db.put(b"key%04d" % i, FBlob(b"v%d" % i))
    da = DeltaAttestor(db.branches)
    da.attest()                                  # full build
    h0 = da.stats.leaf_hashes + da.stats.node_hashes
    assert da.stats.leaf_hashes >= n
    for i in (3, 99, 200):                       # 3 single-head updates
        db.put(b"key%04d" % i, FBlob(b"w%d" % i))
    att = da.attest()
    dh = da.stats.leaf_hashes + da.stats.node_hashes - h0
    # 3 in-place paths: 3 leaves + 3 * ceil(log2 n) nodes, far under n
    assert dh <= 3 * (1 + 10)
    assert att.root == attest_heads(db.branches).root


def test_delta_prove_serves_valid_paths_from_resident_tree(db, rng):
    for i in range(31):
        db.put(b"k%02d" % i, FBlob(rng.bytes(16)))
    db.fork(b"k03", "master", "side")
    att = db.attest(secret=b"s")
    for key, tag in [(b"k00", "master"), (b"k03", "side"),
                     (b"k30", "master")]:
        k, t, uid = verify_head(att, db.prove_head(key, tag).to_bytes(),
                                secret=b"s")
        assert (k, t) == (key, tag)
        assert uid == db.branches.head(key, tag)


def test_delta_survives_hash_algorithm_swap(db, rng):
    from repro_torch.core import hashing
    db.put("k", FBlob(b"v0"))
    att_sha = db.attest()
    hashing.use_fphash()
    try:
        db.put("k", FBlob(b"v1"))
        att_fp = db.attest()                     # forced full rebuild
        assert att_fp.root == attest_heads(db.branches).root
        assert att_fp.root != att_sha.root
    finally:
        hashing.use_sha256()
    assert db.attest().root == attest_heads(db.branches).root
    assert db._delta_attestor.stats.full_rebuilds >= 3


# ------------------------------------------------------------ forge sweep

def test_every_root_bitflip_fails_verify_head(db, rng):
    """Forge sweep over a DELTA-maintained attestation: flipping any
    single bit of the root must break every head proof."""
    import dataclasses
    for i in range(17):
        db.put(b"k%02d" % i, FBlob(rng.bytes(12)))
    db.attest()                                  # build the tree
    for i in (1, 5, 9):                          # then delta-update heads
        db.put(b"k%02d" % i, FBlob(rng.bytes(12)))
    att = db.attest()
    assert att.root == attest_heads(db.branches).root
    proof = db.prove_head(b"k05", "master").to_bytes()
    verify_head(att, proof)                      # sanity: valid as-is
    for byte in range(32):
        for bit in range(8):
            forged_root = (att.root[:byte]
                           + bytes([att.root[byte] ^ (1 << bit)])
                           + att.root[byte + 1:])
            forged = dataclasses.replace(att, root=forged_root)
            with pytest.raises(InvalidProof):
                verify_head(forged, proof)


# ------------------------------------------------- malformed entry decode

def test_malformed_committed_entry_raises_invalid_proof():
    """A garbage entry inside an otherwise valid attestation must fail
    with InvalidProof — not struct.error / UnicodeDecodeError / silent
    truncation — when verify_head decodes it (satellite regression:
    pre-fix this leaked struct.error)."""
    from repro_torch.proof import Attestation
    good = encode_entry(b"k", "master", b"\x11" * 32)
    for garbage in (b"", b"\x01", b"\xff\xff\xff\xff",          # short kl
                    b"\x02\x00\x00\x00k",                        # short key
                    b"\x01\x00\x00\x00k\xff\xff\xff\xffx",       # short tag
                    b"\x01\x00\x00\x00k\x01\x00\x00\x00t\x00',"  # bad uid
                    b"\x01\x00\x00\x00k\x02\x00\x00\x00\xff\xfe"
                    + b"\x00" * 32):                             # bad utf8
        entries = sorted([good, garbage])
        leaves = entry_leaves(entries)
        att = Attestation(merkle_root(leaves), len(entries))
        proof = prove_entry(entries, leaves, garbage)
        with pytest.raises(InvalidProof):
            verify_head(att, proof.to_bytes())


# --------------------------------------------------- GC epoch handshake

def _head_chunks(db, uid):
    from repro_torch.gc import mark
    live, _, missing = mark(db.store, [uid])
    assert missing == 0
    return live


def test_attested_head_survives_next_collection(db, rng):
    """THE orphaning race (ROADMAP): attest commits a head, the branch
    is retired, the next collection must NOT sweep the chunks beneath
    the freshly signed head — prove_member against it has to keep
    working until the second collection after the attest begins."""
    data = {b"e%03d" % i: rng.bytes(16) for i in range(120)}
    uid = db.put("k", FMap(data), "tmp")
    att = db.attest(secret=b"s")
    proof = db.prove_head("k", "tmp")
    db.remove("k", "tmp")                        # head retired post-attest
    rep1 = db.gc()                               # collection epoch 1
    # pre-fix: this collection swept the subgraph and the proofs dangle
    k, t, head = verify_head(att, proof, secret=b"s")
    assert head == uid
    mp = db.prove_member("k", uid=uid, item_key=b"e007")   # still servable
    from repro_torch.proof import verify_member
    obj = db.get("k", uid=uid).obj
    assert verify_member(obj.data, mp).value == data[b"e007"]
    # the grace window is ONE epoch: the second collection reclaims
    rep2 = db.gc()
    assert rep2.swept_chunks > 0
    assert not db.store.has(uid)


def test_attested_head_survives_next_incremental_collection(db, rng):
    uid = db.put("k", FBlob(rng.bytes(20_000)), "tmp")
    db.attest()
    db.remove("k", "tmp")
    db.gc(incremental=True, budget=16)           # epoch 1: fenced
    assert db.get("k", uid=uid) is not None
    rep = db.gc(incremental=True, budget=16)     # epoch 2: reclaimed
    assert rep.swept_chunks > 0


def test_attest_mid_sweep_rescues_condemned_head(db, rng):
    """A head (re)established without a root barrier and then committed
    by an attestation issued MID-SWEEP must be rescued from the live
    condemned set (attest_fence), transitively."""
    from repro_torch.gc import GCPhase
    data = rng.bytes(20_000)
    uid = db.put("k", FBlob(data), "tmp")
    db.remove("k", "tmp")                        # fully detached
    col = db.incremental_gc()
    while col.step(8) is GCPhase.MARK:
        pass
    assert col.phase is GCPhase.SWEEP            # condemned, none swept
    # a rogue/raw head re-establishment that fires NO root barrier:
    db.branches.set_head(b"k", "back", uid)
    db.attest(secret=b"s")                       # commits uid mid-sweep
    while col.step(8) is not GCPhase.DONE:
        pass
    assert db.get("k", "back").blob().read() == data


def test_attestation_context_carries_collector_epoch(db, rng):
    db.put("k", FBlob(b"v"))
    assert attestation_epoch(db.attest(context=b"app")) == 0
    db.gc()
    assert attestation_epoch(db.attest(context=b"app")) == 1
    db.gc(incremental=True, budget=8)
    assert attestation_epoch(db.attest()) == 2
    # foreign attestations without the tag read as None
    assert attestation_epoch(attest_heads(db.branches)) is None


def test_light_client_refreshes_anchor_from_attestation(rng):
    from repro_torch.apps.blockchain import ForkBaseLedger, LightClient
    led = ForkBaseLedger()
    led.write("bank", "alice", b"10")
    led.commit()
    lc = LightClient(led.db.get("chain").uid)
    led.write("bank", "alice", b"20")
    led.commit()                                 # head moved on
    att = led.attest(secret=b"s")
    lc.refresh_head(att, led.prove_chain_head(), secret=b"s")
    assert lc.head_uid == led.db.get("chain").uid
    assert lc.attested_epoch == 0
    dist, val = lc.verify_state(led.prove_state("bank", "alice"),
                                "bank", "alice")
    assert val == b"20"
    # a proof for some other key cannot re-anchor the client
    with pytest.raises(InvalidProof):
        lc.refresh_head(att, led.db.prove_head("__l1__"), secret=b"s")


# ------------------------------------------------------------- caching

def test_prove_member_served_from_per_root_cache(db, rng):
    m = {b"k%03d" % i: rng.bytes(8) for i in range(200)}
    db.put("m", FMap(m))
    p1 = db.prove_member("m", item_key=b"k007")
    p2 = db.prove_member("m", item_key=b"k007")
    assert p2 is p1                              # resident, not re-walked
    assert db.proof_cache.hits == 1
    m[b"k007"] = b"new"
    db.put("m", FMap(m))                         # new root -> cold cache
    p3 = db.prove_member("m", item_key=b"k007")
    assert p3 is not p1
    from repro_torch.proof import verify_member
    assert verify_member(db.get("m").obj.data,
                         p3.to_bytes()).value == b"new"
    # absence proofs share the cache
    a1 = db.prove_absence("m", item_key=b"zzz")
    assert db.prove_absence("m", item_key=b"zzz") is a1


def test_verify_memo_persists_across_rounds(db, rng):
    from repro_torch.proof import prove_member as pm
    from repro_torch.core.postree import POSTree
    db.put("m", FMap({b"k%04d" % i: rng.bytes(8) for i in range(400)}))
    obj = db.get("m").obj
    tree = POSTree.from_root(db.store, obj.type, obj.data, PARAMS)
    items = [(obj.data, pm(tree, pos=i * 7)) for i in range(30)]
    memo = VerifyMemo()
    verify_member_many(items, memo=memo)
    m1 = memo.misses
    assert m1 > 0 and memo.hits == 0
    verify_member_many(items, memo=memo)         # round 2: all resident
    assert memo.misses == m1
    assert memo.hits >= m1
    # forged proofs still fail under the memo
    import dataclasses
    bad = dataclasses.replace(items[0][1], value=b"forged")
    with pytest.raises(InvalidProof):
        verify_member_many([(items[0][0], bad)], memo=memo)


# ------------------------------------------------------------ audit daemon

def test_cluster_attestations_carry_cluster_epoch(rng):
    cl = Cluster(3, params=PARAMS)
    for i in range(6):
        cl.put("key%d" % i, FBlob(rng.bytes(500)))
    catt, atts = cl.attest(secret=b"s")
    assert attestation_epoch(catt) == 0
    assert all(attestation_epoch(a) == 0 for a in atts)
    cl.gc()
    catt, atts = cl.attest(secret=b"s")
    assert attestation_epoch(catt) == 1
    assert all(attestation_epoch(a) == 1 for a in atts)


def test_cluster_attested_head_survives_next_collection(rng):
    cl = Cluster(3, params=PARAMS)
    cl.put("key", FBlob(rng.bytes(9_000)), "tmp")
    svc = cl.servlet_of("key")
    uid = svc.branches.head(b"key", "tmp")
    cl.attest(secret=b"s")                       # pins every servlet head
    cl.remove("key", "tmp")
    cl.gc()                                      # epoch 1: fenced
    assert cl.get("key", uid=uid).blob().read() is not None
    rep = cl.gc()                                # epoch 2: reclaimed
    assert rep.swept_chunks > 0


def _mk_cluster(rng, n=3, keys=8):
    cl = Cluster(n, params=PARAMS)
    for i in range(keys):
        cl.put("key%d" % i, FMap({b"e%02d" % j: rng.bytes(12)
                                  for j in range(40)}))
    return cl


def test_daemon_backs_off_clean_nodes(rng):
    cl = _mk_cluster(rng)
    d = cl.audit_daemon(sample=64, secret=b"s", max_interval=16)
    for _ in range(60):
        rep = cl.audit_tick(budget=2)
        assert rep.ok
    # every target audited clean repeatedly -> intervals at the cap
    assert all(iv == 16 for iv in d._interval.values())
    # backoff means far fewer audits than (ticks x targets)
    assert d.audits < 60 * len(d._interval) / 2
    assert not d.quarantined


def test_daemon_quarantines_on_repeatable_finding(rng):
    cl = _mk_cluster(rng)
    d = cl.audit_daemon(sample=64, secret=b"s", max_interval=8)
    for _ in range(20):
        assert cl.audit_tick(budget=2).ok
    audits_before = d.audits
    # corrupt a head meta chunk on one node (heads are always checked)
    ni = next(i for i, nd in enumerate(cl.nodes)
              if nd.servlet.branches.keys())
    key = cl.nodes[ni].servlet.branches.keys()[0]
    uid = cl.nodes[ni].servlet.branches.head(key, "master")
    raw = cl.nodes[ni].store._data[uid]
    cl.nodes[ni].store._data[uid] = raw[:-1] + bytes([raw[-1] ^ 1])
    bad_tick = None
    for t in range(20):
        rep = cl.audit_tick(budget=2)
        if not rep.ok:
            bad_tick = t
            break
    assert bad_tick is not None
    assert f"node{ni}" in d.quarantined
    # the finding triggered an immediate re-audit (two audits that tick)
    assert d.audits >= audits_before + 2
    assert any(f.node == f"node{ni}" for f in d.findings)
    # repair + release: node re-enters rotation and audits clean again
    cl.nodes[ni].store._data[uid] = raw
    d.release(f"node{ni}")
    assert all(cl.audit_tick(budget=2).ok for _ in range(10))
    assert f"node{ni}" not in d.quarantined


def test_daemon_transient_finding_does_not_quarantine(rng):
    """A finding that vanishes on the immediate re-audit (read race,
    repaired replica) must not quarantine the node."""
    from repro_torch.proof.audit import AuditDaemon
    cl = _mk_cluster(rng)
    d = AuditDaemon(cl, sample=64, secret=b"s")
    ni = 0
    while not cl.nodes[ni].servlet.branches.keys():
        ni += 1
    key = cl.nodes[ni].servlet.branches.keys()[0]
    uid = cl.nodes[ni].servlet.branches.head(key, "master")
    raw = cl.nodes[ni].store._data[uid]
    cl.nodes[ni].store._data[uid] = raw[:-1] + bytes([raw[-1] ^ 1])
    flipped = {"done": False}
    orig = d._audit_target

    def healing(target):
        rep = orig(target)
        if not rep.ok and not flipped["done"]:
            cl.nodes[ni].store._data[uid] = raw      # repaired in between
            flipped["done"] = True
        return rep

    d._audit_target = healing
    for _ in range(20):
        d.tick(budget=2)
    assert flipped["done"]                       # the finding did surface
    assert not d.quarantined                     # but did not stick


def test_daemon_covers_placement(rng):
    """The master-index placement check is its own backoff target: a
    chunk lost by its owning node is found without any engine audit."""
    from repro_torch.proof.audit import AuditDaemon
    cl = _mk_cluster(rng)
    d = AuditDaemon(cl, sample=10_000, secret=b"s")
    cid, ni = next(iter(cl.index.items()))
    del cl.nodes[ni].store._data[cid]            # node silently lost it
    seen = []
    for _ in range(12):
        seen.extend(d.tick(budget=4).findings)
    assert any(f.kind == "missing" and f.cid == cid for f in seen)
    assert f"node{ni}" in d.quarantined
