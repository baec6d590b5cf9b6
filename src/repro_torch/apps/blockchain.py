"""Hyperledger-v0.6-style blockchain on ForkBase (paper §5.1, Fig. 7b).

Data model: the Merkle tree + state delta of Fig. 7(a) collapse into
ForkBase-native structures:

  * per (contract, key) the value lives in a Blob under ForkBase key
    "<contract>/<key>" — its version chain IS the state history, so
    *state scan* is just Track (no chain replay);
  * a two-level Map mirrors Fig. 7(b): level-1 Map contract -> uid of the
    level-2 Map (key -> value-Blob uid).  The level-1 Map's uid replaces
    the Merkle state hash;
  * each block is a Put on key "chain": an FMap {state root uid, txs};
    the block's ``bases`` chain is the hash-linked ledger, tamper-evident
    for free (§3.2).

*Block scan* walks the block's level-1/level-2 Maps directly.  The paper's
headline: this replaced 1918 lines of Hyperledger state-management code
with ~18 lines of ForkBase calls — the commit path below is the analogous
handful of Puts.

``live=True`` switches the ledger onto the forkless flat-state fast
path (repro_torch.live): all state lives as "<contract>/<key>" ->
value-bytes entries of ONE LiveTable on key ``__state__``.  Reads and
writes are O(1) dict operations; ``commit`` folds the dirty delta into the backing
POS-Tree map with a single batched splice, and the block references the
folded root uid as its state root.  History granularity becomes
per-block instead of per-op — exactly the ledger contract, since intra-
block intermediate states were never observable anyway — and state
proofs flatten to one membership proof (``prove_state_flat``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass

from ..core import FBlob, FMap, ForkBase


@dataclass
class Tx:
    contract: str
    op: str                 # 'put' | 'get'
    key: str
    value: bytes | None = None


STATE_KEY = "__state__"          # LiveTable key of the flat state (live mode)


class ForkBaseLedger:
    def __init__(self, db: ForkBase | None = None, *, live: bool = False):
        self.db = db if db is not None else ForkBase()
        self.height = 0
        self.live = live
        self._state = self.db.live(STATE_KEY) if live else None
        self._pending: list[Tx] = []
        self._writes: dict[tuple[str, str], bytes] = {}

    @staticmethod
    def _sk(contract: str, key: str) -> bytes:
        return f"{contract}/{key}".encode()

    # ---------------------------------------------------- tx processing
    def read(self, contract: str, key: str) -> bytes | None:
        w = self._writes.get((contract, key))
        if w is not None:
            return w
        if self.live:
            return self._state.get(self._sk(contract, key))
        h = self.db.get(f"{contract}/{key}")
        return h.blob().read() if h is not None else None

    def write(self, contract: str, key: str, value: bytes) -> None:
        # buffered in the tx context until commit (paper Fig. 9b: a write
        # only buffers the new value)
        self._writes[(contract, key)] = value
        self._pending.append(Tx(contract, "put", key, value))

    # ----------------------------------------------------------- commit
    def commit(self) -> bytes:
        """Batch-commit buffered writes into a new block."""
        if self.live:
            return self._commit_live()
        by_contract: dict[str, dict[str, bytes]] = {}
        for (c, k), v in self._writes.items():
            by_contract.setdefault(c, {})[k] = v
        # 1) value blobs — one versioned Put per state key
        l2_uids: dict[str, bytes] = {}
        for c, kv in by_contract.items():
            for k, v in kv.items():
                h = self.db.get(f"{c}/{k}")
                if h is None:
                    uid = self.db.put(f"{c}/{k}", FBlob(v))
                else:
                    b = h.blob()
                    b.replace(0, len(b), v)
                    uid = self.db.put(f"{c}/{k}", b)
            # 2) level-2 map for this contract (key -> blob uid)
            h2 = self.db.get(f"__l2__/{c}")
            m2 = h2.map() if h2 is not None else FMap()
            for k in kv:
                head = self.db.get(f"{c}/{k}")
                m2.set(k.encode(), head.uid)
            l2_uids[c] = self.db.put(f"__l2__/{c}", m2)
        # 3) level-1 map (contract -> level-2 uid)
        h1 = self.db.get("__l1__")
        m1 = h1.map() if h1 is not None else FMap()
        for c, uid in l2_uids.items():
            m1.set(c.encode(), uid)
        state_root = self.db.put("__l1__", m1)
        # 4) block
        blk = FMap({b"state": state_root,
                    b"txs": json.dumps(
                        [(t.contract, t.op, t.key) for t in self._pending]
                    ).encode()})
        block_uid = self.db.put("chain", blk,
                                context=json.dumps(
                                    {"height": self.height}).encode())
        self.height += 1
        self._pending.clear()
        self._writes.clear()
        return block_uid

    def _commit_live(self) -> bytes:
        """Live-mode commit: buffered writes land in the flat table
        (O(1) each), ONE epoch fold batch-splices the delta into the
        ``__state__`` POS-Tree map, and the block binds the folded root
        uid — the flat-path replacement for steps 1-3 above."""
        for (c, k), v in self._writes.items():
            self._state.put(self._sk(c, k), v)
        rep = self._state.fold(
            context=json.dumps({"height": self.height}).encode())
        blk = FMap({b"state": rep.uid,
                    b"txs": json.dumps(
                        [(t.contract, t.op, t.key) for t in self._pending]
                    ).encode()})
        block_uid = self.db.put("chain", blk,
                                context=json.dumps(
                                    {"height": self.height}).encode())
        self.height += 1
        self._pending.clear()
        self._writes.clear()
        return block_uid

    # -------------------------------------------------------- analytics
    def state_scan(self, contract: str, key: str, limit: int = 1 << 30):
        """History of one state key: follow the Blob version chain —
        no chain replay, no pre-processing (paper Fig. 12a).  In live
        mode the chain is the per-epoch version chain of the flat state
        map (one entry per block that changed the key)."""
        out = []
        if self.live:
            sk = self._sk(contract, key)
            prev = object()
            for obj in self.db.track(STATE_KEY, "master", (0, limit)):
                v = self.db.get(STATE_KEY, uid=obj.uid).map().get(sk)
                if v is not None and v != prev:
                    out.append((obj.uid, bytes(v)))
                    prev = bytes(v)
            return out
        for obj in self.db.track(f"{contract}/{key}", "master",
                                 (0, limit)):
            h = self.db.get(f"{contract}/{key}", uid=obj.uid)
            out.append((obj.uid, h.blob().read()))
        return out

    def block_scan(self, height: int):
        """All states at a given block: walk that block's 2-level Map
        (archive mode) or its flat state map (live mode)."""
        blocks = self.db.track("chain", "master")
        blk = blocks[self.height - 1 - height]
        bm = self.db.get("chain", uid=blk.uid).map()
        state_root = bm.get(b"state")
        out = {}
        if self.live:
            m = self.db.get(STATE_KEY, uid=state_root).map()
            for sk, v in m.items():
                c, _, k = sk.decode().partition("/")
                out[(c, k)] = bytes(v)
            return out
        m1 = self.db.get("__l1__", uid=state_root).map()
        for c, l2uid in m1.items():
            m2 = self.db.get(f"__l2__/{c.decode()}", uid=l2uid).map()
            for k, buid in m2.items():
                h = self.db.get(f"{c.decode()}/{k.decode()}", uid=buid)
                out[(c.decode(), k.decode())] = h.blob().read()
        return out

    def verify_block(self, height: int) -> bool:
        """Tamper evidence: block at `height` must be an ancestor of the
        chain head."""
        blocks = self.db.track("chain", "master")
        head = blocks[0].uid
        target = blocks[self.height - 1 - height].uid
        return self.db.verify_lineage(head, target)

    # ------------------------------------------------- light-client proofs
    def attest(self, secret: bytes | None = None):
        """Delta head attestation over the ledger engine (HMAC-signed
        with ``secret``): committing a block re-hashes only the touched
        heads' O(log n) paths, so attest-per-block is cheap.  A light
        client refreshes its trust anchor from (attestation,
        ``prove_chain_head()``) instead of an out-of-band head uid."""
        return self.db.attest(context=b"ledger", secret=secret)

    def prove_chain_head(self):
        """Audit path binding the chain head to ``attest()``'s root."""
        return self.db.prove_head("chain")

    def block_uid(self, height: int) -> bytes:
        return self.db.track("chain", "master")[self.height - 1 - height].uid

    def prove_block(self, height: int):
        """Lineage proof chain-head -> block (proof subsystem): a light
        client holding only the head uid authenticates the block and its
        distance from the head."""
        return self.db.prove_lineage(self.db.get("chain").uid,
                                     self.block_uid(height))

    def prove_state(self, contract: str, key: str,
                    height: int | None = None) -> "StateProof":
        """Full stateless state proof for one (contract, key) at a block:
        chain-head lineage -> block meta -> Fig. 7(b)'s two-level Map by
        membership proofs -> the value Blob, one leaf proof per chunk.
        Everything an untrusting client needs; no store handle anywhere."""
        from ..core.postree import POSTree
        from ..proof.membership import prove_member
        height = self.height - 1 if height is None else height
        db = self.db
        block_uid = self.block_uid(height)
        lineage = db.prove_lineage(db.get("chain").uid, block_uid)
        block_raw = db.prove_version(block_uid)
        state_entry = db.prove_member("chain", uid=block_uid,
                                      item_key=b"state")
        l1_uid = bytes(db.get("chain", uid=block_uid).map().get(b"state"))
        l1_raw = db.prove_version(l1_uid)
        l1_entry = db.prove_member("__l1__", uid=l1_uid,
                                   item_key=contract.encode())
        l2_uid = bytes(db.get("__l1__", uid=l1_uid).map()
                       .get(contract.encode()))
        l2_raw = db.prove_version(l2_uid)
        l2_entry = db.prove_member(f"__l2__/{contract}", uid=l2_uid,
                                   item_key=key.encode())
        blob_uid = bytes(db.get(f"__l2__/{contract}", uid=l2_uid).map()
                         .get(key.encode()))
        blob_obj = db.get(f"{contract}/{key}", uid=blob_uid).obj
        value_raw = db.prove_version(blob_uid)
        tree = POSTree.from_root(db.store, blob_obj.type, blob_obj.data,
                                 db.params)
        value = tree.read_bytes(0, tree.total_count)
        # one membership proof per leaf: their payloads tile the value
        starts, s = [], 0
        for e in tree.levels[0]:
            starts.append(s)
            s += e.count
        value_proofs = tuple(prove_member(tree, pos=p).to_bytes()
                             for p in starts) if value else ()
        return StateProof(lineage.to_bytes(), block_raw,
                          state_entry.to_bytes(), l1_raw,
                          l1_entry.to_bytes(), l2_raw,
                          l2_entry.to_bytes(), value_raw, value,
                          value_proofs)

    def prove_state_flat(self, contract: str, key: str,
                         height: int | None = None) -> "FlatStateProof":
        """Live-mode stateless state proof: the two-level Map of
        ``prove_state`` collapses to ONE membership proof into the flat
        ``__state__`` map, whose leaf carries the value bytes directly —
        chain-head lineage -> block meta -> state-root entry -> kv
        entry.  Strictly smaller than the archival StateProof."""
        if not self.live:
            raise ValueError("prove_state_flat requires live mode")
        height = self.height - 1 if height is None else height
        db = self.db
        block_uid = self.block_uid(height)
        lineage = db.prove_lineage(db.get("chain").uid, block_uid)
        block_raw = db.prove_version(block_uid)
        state_entry = db.prove_member("chain", uid=block_uid,
                                      item_key=b"state")
        state_uid = bytes(db.get("chain", uid=block_uid).map()
                          .get(b"state"))
        state_raw = db.prove_version(state_uid)
        kv_entry = db.prove_member(STATE_KEY, uid=state_uid,
                                   item_key=self._sk(contract, key))
        return FlatStateProof(lineage.to_bytes(), block_raw,
                              state_entry.to_bytes(), state_raw,
                              kv_entry.to_bytes())


@dataclass(frozen=True)
class StateProof:
    """Server-emitted bundle for LightClient.verify_state.  Each layer is
    an independent stateless proof; the client threads the trust anchor
    through them: head uid -> block -> state root -> contract map ->
    value blob -> value bytes."""
    lineage: bytes            # head -> block meta-chunk chain
    block_raw: bytes          # block version record
    state_entry: bytes        # b"state" in the block Map
    l1_raw: bytes             # level-1 Map version record
    l1_entry: bytes           # contract -> level-2 uid
    l2_raw: bytes             # level-2 Map version record
    l2_entry: bytes           # key -> value-blob uid
    value_raw: bytes          # value Blob version record
    value: bytes              # the claimed state bytes
    value_proofs: tuple[bytes, ...]   # one leaf proof per value chunk

    @property
    def size(self) -> int:
        return (len(self.lineage) + len(self.block_raw)
                + len(self.state_entry) + len(self.l1_raw)
                + len(self.l1_entry) + len(self.l2_raw)
                + len(self.l2_entry) + len(self.value_raw)
                + len(self.value) + sum(map(len, self.value_proofs)))


@dataclass(frozen=True)
class FlatStateProof:
    """Live-mode counterpart of StateProof: head uid -> block -> flat
    state-map root -> (key, value) leaf entry, value bytes inline."""
    lineage: bytes            # head -> block meta-chunk chain
    block_raw: bytes          # block version record
    state_entry: bytes        # b"state" in the block Map
    state_raw: bytes          # flat __state__ map version record
    kv_entry: bytes           # "<contract>/<key>" -> value bytes

    @property
    def size(self) -> int:
        return (len(self.lineage) + len(self.block_raw)
                + len(self.state_entry) + len(self.state_raw)
                + len(self.kv_entry))


class LightClient:
    """Holds ONLY the trusted chain-head uid — no ledger, no store.
    The paper's tamper-evidence story (§3.2) made operational: a replica
    cannot present a spliced history, a substituted block, or a forged
    state value without breaking one of the hash chains checked here."""

    def __init__(self, head_uid: bytes):
        self.head_uid = bytes(head_uid)
        self.attested_epoch: int | None = None   # GC epoch of the anchor

    def refresh_head(self, attestation, head_proof,
                     secret: bytes | None = None) -> bytes:
        """Adopt a new trust anchor from a (signed) delta attestation +
        head proof: the attested chain head becomes ``head_uid`` only if
        the proof closes against the attestation root (and the HMAC
        checks out when ``secret`` is given).  Records the attestation's
        GC epoch: the epoch-fence handshake guarantees proofs against
        this anchor stay servable until the second collection after the
        attested epoch begins, so a client comparing epochs knows when
        it must refresh."""
        from ..proof import InvalidProof, verify_head
        from ..proof.delta import attestation_epoch
        from ..proof.attest import verify_attestation
        key, tag, uid = verify_head(attestation, head_proof, secret=secret)
        if key != b"chain" or tag != "master":
            raise InvalidProof("attested head is not the chain head")
        self.head_uid = bytes(uid)
        self.attested_epoch = attestation_epoch(
            verify_attestation(attestation))
        return self.head_uid

    def verify_block(self, lineage_proof, block_uid: bytes) -> int:
        """Authenticates ``block_uid`` as an ancestor of the trusted
        head; returns its distance from the head."""
        from ..proof import verify_lineage
        return len(verify_lineage(self.head_uid, block_uid,
                                  lineage_proof)) - 1

    def verify_state(self, proof: StateProof,
                     contract: str, key: str) -> tuple[int, bytes]:
        """Returns (block distance from head, authenticated value bytes);
        raises proof.InvalidProof on any forged layer."""
        from ..core import chunk as ck
        from ..core.hashing import content_hash_many
        from ..proof import (InvalidProof, LineageProof, MembershipProof,
                             verify_lineage, verify_member,
                             verify_version)
        lp = LineageProof.from_bytes(proof.lineage)
        if not lp.raws:
            raise InvalidProof("empty lineage")
        # the chain from the trusted head authenticates its own tail
        block_uid = content_hash_many([lp.raws[-1]])[0]
        chain = verify_lineage(self.head_uid, block_uid, lp)
        block = verify_version(block_uid, proof.block_raw)
        claim = verify_member(block.data, proof.state_entry)
        if claim.key != b"state":
            raise InvalidProof("state-root entry proves the wrong key")
        l1 = verify_version(claim.value, proof.l1_raw)
        claim = verify_member(l1.data, proof.l1_entry)
        if claim.key != contract.encode():
            raise InvalidProof("contract entry proves the wrong key")
        l2 = verify_version(claim.value, proof.l2_raw)
        claim = verify_member(l2.data, proof.l2_entry)
        if claim.key != key.encode():
            raise InvalidProof("state-key entry proves the wrong key")
        blob = verify_version(claim.value, proof.value_raw)
        # value completeness: verified leaf payloads must tile the
        # claimed bytes exactly and cover the tree's full item count;
        # an EMPTY claim is only accepted when the authenticated root
        # IS the canonical empty-blob leaf (a server cannot present a
        # non-empty state as empty by dropping the leaf proofs)
        if not proof.value_proofs:
            empty_root = content_hash_many(
                [ck.encode_chunk(ck.BLOB, b"")])[0]
            if proof.value != b"" or blob.data != empty_root:
                raise InvalidProof("value proof does not cover the value")
            return len(chain) - 1, b""
        pos, total = 0, None
        for vp in proof.value_proofs:
            mp = MembershipProof.from_bytes(vp)
            c = verify_member(blob.data, mp)
            if c.pos != pos:
                raise InvalidProof("value leaves not contiguous")
            payload = ck.chunk_payload(mp.leaf)
            if proof.value[pos:pos + len(payload)] != payload:
                raise InvalidProof("claimed value bytes diverge")
            pos += len(payload)
            if total is None:
                total = (_root_count(mp) if mp.nodes
                         else len(payload))
        if pos != len(proof.value) or (total or 0) != len(proof.value):
            raise InvalidProof("value proof does not cover the value")
        return len(chain) - 1, proof.value

    def verify_state_flat(self, proof: FlatStateProof,
                          contract: str, key: str) -> tuple[int, bytes]:
        """Live-mode verifier: same trust threading as ``verify_state``
        but through the flat state map — the kv leaf IS the value, so
        there is no per-chunk tiling to check."""
        from ..core.hashing import content_hash_many
        from ..proof import (InvalidProof, LineageProof, verify_lineage,
                             verify_member, verify_version)
        lp = LineageProof.from_bytes(proof.lineage)
        if not lp.raws:
            raise InvalidProof("empty lineage")
        block_uid = content_hash_many([lp.raws[-1]])[0]
        chain = verify_lineage(self.head_uid, block_uid, lp)
        block = verify_version(block_uid, proof.block_raw)
        claim = verify_member(block.data, proof.state_entry)
        if claim.key != b"state":
            raise InvalidProof("state-root entry proves the wrong key")
        state = verify_version(claim.value, proof.state_raw)
        claim = verify_member(state.data, proof.kv_entry)
        if claim.key != f"{contract}/{key}".encode():
            raise InvalidProof("kv entry proves the wrong key")
        return len(chain) - 1, bytes(claim.value)


def _root_count(mp) -> int:
    """Authenticated total item count from a proof's root index node."""
    from ..core import chunk as ck
    entries = ck.decode_uindex(ck.chunk_payload(mp.nodes[0]))
    return sum(e.count for e in entries)
