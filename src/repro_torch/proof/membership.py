"""Merkle membership & absence proofs over the POS-Tree (paper §3.2,
§4.3; UStore's verifiable access made a first-class verb).

A proof carries the raw chunk chain root→leaf (full index nodes — their
pattern-split metadata *is* the audit path: child cids, subtree counts,
max keys) plus the claimed item.  ``verify_member`` recomputes every cid
bottom-up with **no store access**: a verifier holding only a trusted
root cid accepts the claim iff the hash chain closes and the claimed
item sits where the navigation metadata says it must.

Absence proofs (sorted kinds only) reuse the same chain: the verifier
re-derives the unique leaf that could contain the key (first max-key
covering it at every level) and checks neighbor-entry enclosure —
predecessor < key < successor inside that hash-authenticated leaf (the
reported enclosure is leaf-local; see Claim.enclosure).

Batch verification (``verify_member_many``) is where the kernel path
pays off: distinct nodes across all proofs are hashed with ONE
``content_hash_many`` dispatch (one ``fphash_many`` launch), and shared
index nodes/leaves are decoded once — an auditor checking thousands of proofs
from the same tree does O(distinct nodes) work, not O(proofs x height).
"""
from __future__ import annotations

import bisect
import struct
from collections import OrderedDict
from dataclasses import dataclass

from ..core import chunk as ck
from ..core.hashing import content_hash_many, current_hash
from ..core.postree import SORTED_KINDS, child_by_key, child_by_pos
from ..errors import InvalidProof  # noqa: F401  re-exported: historical home

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

MAGIC = 0xFB
MEMBER_BY_POS = 1
MEMBER_BY_KEY = 2
ABSENCE = 3

_CHUNK_KINDS = (ck.BLOB, ck.LIST, ck.SET, ck.MAP)


@dataclass(frozen=True)
class Claim:
    """What a successfully verified proof establishes."""
    mode: int                 # MEMBER_BY_POS / MEMBER_BY_KEY / ABSENCE
    kind: int                 # chunk kind of the proven tree
    pos: int                  # item position (MEMBER_BY_POS)
    key: bytes                # item key (key modes)
    value: bytes              # item bytes (member modes)
    enclosure: tuple[bytes | None, bytes | None] | None = None
    # ABSENCE: the authenticated (predecessor, successor) neighbors
    # WITHIN the candidate leaf.  A None side means the absent key falls
    # beyond this leaf's key range — the global neighbor then lives in
    # an adjacent leaf the proof does not carry (range proofs are the
    # ROADMAP follow-on).  The absence claim itself is always global:
    # navigation pins the unique leaf that could hold the key.


@dataclass(frozen=True)
class MembershipProof:
    mode: int
    kind: int
    pos: int
    key: bytes
    value: bytes
    nodes: tuple[bytes, ...]   # index node raws, root-down
    leaf: bytes                # leaf chunk raw

    # ------------------------------------------------------------- wire
    def to_bytes(self) -> bytes:
        parts = [bytes([MAGIC, self.mode, self.kind]),
                 _U64.pack(self.pos),
                 _U32.pack(len(self.key)), self.key,
                 _U32.pack(len(self.value)), self.value,
                 _U16.pack(len(self.nodes))]
        for raw in self.nodes:
            parts.append(_U32.pack(len(raw)))
            parts.append(raw)
        parts.append(_U32.pack(len(self.leaf)))
        parts.append(self.leaf)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "MembershipProof":
        try:
            if data[0] != MAGIC:
                raise InvalidProof("bad magic")
            mode, kind = data[1], data[2]
            i = 3
            (pos,) = _U64.unpack_from(data, i); i += 8
            (kl,) = _U32.unpack_from(data, i); i += 4
            key = bytes(data[i:i + kl]); i += kl
            if len(key) != kl:
                raise InvalidProof("truncated key")
            (vl,) = _U32.unpack_from(data, i); i += 4
            value = bytes(data[i:i + vl]); i += vl
            if len(value) != vl:
                raise InvalidProof("truncated value")
            (nn,) = _U16.unpack_from(data, i); i += 2
            nodes = []
            for _ in range(nn):
                (ln,) = _U32.unpack_from(data, i); i += 4
                nodes.append(bytes(data[i:i + ln])); i += ln
                if len(nodes[-1]) != ln:
                    raise InvalidProof("truncated node")
            (ln,) = _U32.unpack_from(data, i); i += 4
            leaf = bytes(data[i:i + ln]); i += ln
            if len(leaf) != ln or i != len(data):
                raise InvalidProof("bad framing")
        except (struct.error, IndexError) as e:
            raise InvalidProof(f"unparseable proof: {e}") from e
        return cls(mode, kind, pos, key, value, tuple(nodes), leaf)

    @property
    def size(self) -> int:
        return len(self.to_bytes())

    @property
    def height(self) -> int:
        return len(self.nodes) + 1


# ---------------------------------------------------------------- caching

class ProofCache:
    """Per-root audit-path cache (ROADMAP "proof caching"): a proof for
    (root cid, item) is immutable because the root is content-addressed
    — mutating the tree yields a NEW root, so a stale entry is
    unreachable by construction and invalidation is free.  Eviction is
    whole-root LRU: hot trees keep their paths resident, cold roots age
    out with every proof under them."""

    def __init__(self, max_roots: int = 128,
                 max_proofs_per_root: int = 4096):
        self.max_roots = max_roots
        self.max_proofs_per_root = max_proofs_per_root
        self._roots: OrderedDict[bytes, dict] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, root: bytes, req) -> "MembershipProof | None":
        entry = self._roots.get(root)
        if entry is None:
            self.misses += 1
            return None
        self._roots.move_to_end(root)
        proof = entry.get(req)
        if proof is None:
            self.misses += 1
        else:
            self.hits += 1
        return proof

    def store(self, root: bytes, req, proof: "MembershipProof") -> None:
        entry = self._roots.get(root)
        if entry is None:
            entry = self._roots[root] = {}
            while len(self._roots) > self.max_roots:
                self._roots.popitem(last=False)
        if len(entry) < self.max_proofs_per_root:
            entry[req] = proof
        self._roots.move_to_end(root)

    def clear(self) -> None:
        self._roots.clear()


class VerifyMemo:
    """Persistent decoded-node memo for ``verify_member_many`` across
    rounds (ROADMAP: the batched verifier's per-call dedup "could
    persist across audit rounds").  Content addressing makes the memo
    coherent: the digest/decoding of a raw chunk never changes — except
    when the active cid hash is swapped, which clears it wholesale.
    Bounded: when the node table outgrows ``max_nodes`` after a round
    it is reset (audit batches re-warm it in one dispatch)."""

    def __init__(self, max_nodes: int = 8192):
        self.max_nodes = max_nodes
        self.digest: dict[bytes, bytes] = {}
        self.index: dict[tuple[bytes, int], list] = {}
        self.leaf: dict[tuple[bytes, int], object] = {}
        self.hits = 0
        self.misses = 0
        self._hash_fn = current_hash()

    def refresh(self) -> None:
        cur = current_hash()
        if cur is not self._hash_fn:
            self.clear()
            self._hash_fn = cur

    def add_digests(self, raws: list[bytes]) -> None:
        """Hash the raws not yet memoized — ONE batched dispatch."""
        fresh = [r for r in raws if r not in self.digest]
        self.hits += len(raws) - len(fresh)
        self.misses += len(fresh)
        if fresh:
            self.digest.update(zip(fresh, content_hash_many(fresh)))

    def trim(self) -> None:
        if len(self.digest) > self.max_nodes:
            self.clear()

    def clear(self) -> None:
        self.digest.clear()
        self.index.clear()
        self.leaf.clear()


# ------------------------------------------------------------------ prove

def prove_member(tree, *, pos: int | None = None,
                 key: bytes | None = None) -> MembershipProof:
    """Audit path + claim for item ``pos`` (any kind) or sorted-kind
    ``key``.  The claimed value is the serialized element: a single byte
    for Blob, the element for List/Set, ``pack_kv(k, v)`` for Map by
    position, the mapped value for Map by key."""
    if (pos is None) == (key is None):
        raise ValueError("exactly one of pos/key")
    if key is not None:
        if tree.kind not in SORTED_KINDS:
            raise ValueError("key proofs need a sorted kind (Set/Map)")
        if key == b"":
            raise ValueError("empty keys must be proven by position")
        found, _, _, gpos = tree.find_key(key)
        if not found:
            raise KeyError(key)
        nodes, leaf = tree.audit_path(key=key)
        value = b""
        if tree.kind == ck.MAP:
            for k, v in ck.unpack_kv_stream(ck.chunk_payload(leaf)):
                if k == key:
                    value = v
                    break
        return MembershipProof(MEMBER_BY_KEY, tree.kind, 0, key, value,
                               tuple(nodes), leaf)
    if not (0 <= pos < tree.total_count):
        raise IndexError(pos)
    nodes, leaf = tree.audit_path(pos=pos)
    el = tree.get_item(pos)
    if tree.kind == ck.BLOB:
        value = bytes([int(el)])
    elif tree.kind == ck.MAP:
        value = ck.pack_kv(*el)
    else:
        value = bytes(el)
    return MembershipProof(MEMBER_BY_POS, tree.kind, pos, b"", value,
                           tuple(nodes), leaf)


def prove_absence(tree, key: bytes) -> MembershipProof:
    """Negative proof (sorted kinds): the unique leaf that could contain
    ``key``, with enclosure checked by the verifier."""
    if tree.kind not in SORTED_KINDS:
        raise ValueError("absence proofs need a sorted kind (Set/Map)")
    if key == b"":
        raise ValueError("cannot prove absence of the empty key")
    found, _, _, _ = tree.find_key(key)
    if found:
        raise KeyError(f"present: {key!r}")
    nodes, leaf = tree.audit_path(key=key)
    return MembershipProof(ABSENCE, tree.kind, 0, key, b"",
                           tuple(nodes), leaf)


# ----------------------------------------------------------------- verify

def _leaf_items(kind: int, leaf_raw: bytes):
    payload = ck.chunk_payload(leaf_raw)
    if kind == ck.BLOB:
        return payload
    if kind == ck.MAP:
        return ck.unpack_kv_stream(payload)
    return ck.unpack_lv_stream(payload)


def _decode_index(raw: bytes, kind: int):
    t = ck.chunk_type(raw)
    sorted_kind = kind in SORTED_KINDS
    if t != (ck.SINDEX if sorted_kind else ck.UINDEX):
        raise InvalidProof(f"wrong index node type {t}")
    dec = ck.decode_sindex if sorted_kind else ck.decode_uindex
    return dec(ck.chunk_payload(raw))


def _check_claim(p: MembershipProof, items, pos: int) -> Claim:
    """Leaf-level claim check; ``pos`` is local after navigation."""
    if p.mode == MEMBER_BY_POS:
        if not (0 <= pos < len(items)):
            raise InvalidProof("position outside leaf")
        el = items[pos]
        if p.kind == ck.BLOB:
            got = bytes([el])
        elif p.kind == ck.MAP:
            got = ck.pack_kv(*el)
        else:
            got = bytes(el)
        if got != p.value:
            raise InvalidProof("claimed element mismatch")
        return Claim(p.mode, p.kind, p.pos, b"", p.value)
    keys = [kv[0] for kv in items] if p.kind == ck.MAP else list(items)
    if p.mode == MEMBER_BY_KEY:
        if p.key not in keys:
            raise InvalidProof("key not in authenticated leaf")
        if p.kind == ck.MAP:
            got = dict(items)[p.key]
        else:
            got = b""
        if got != p.value:
            raise InvalidProof("claimed value mismatch")
        return Claim(p.mode, p.kind, 0, p.key, p.value)
    # ABSENCE: enclosure inside the unique candidate leaf
    if p.key in keys:
        raise InvalidProof("key present — not absent")
    j = bisect.bisect_left(keys, p.key)
    pred = keys[j - 1] if j > 0 else None
    succ = keys[j] if j < len(keys) else None
    return Claim(p.mode, p.kind, 0, p.key, b"", (pred, succ))


def _verify_one(root_cid: bytes, p: MembershipProof, hash_of,
                decode_index, leaf_items) -> Claim:
    """Shared chain walk; ``hash_of``/``decode_index``/``leaf_items``
    are injected so the batched verifier can memoize across proofs."""
    if p.mode not in (MEMBER_BY_POS, MEMBER_BY_KEY, ABSENCE):
        raise InvalidProof(f"unknown mode {p.mode}")
    if p.kind not in _CHUNK_KINDS:
        raise InvalidProof(f"not a chunkable kind: {p.kind}")
    if p.mode == MEMBER_BY_POS:
        if p.key != b"":
            raise InvalidProof("positional proof carries a key")
    else:
        if p.kind not in SORTED_KINDS:
            raise InvalidProof("key proof on an unsorted kind")
        if p.pos != 0 or p.key == b"":
            raise InvalidProof("key proof framing")
        if p.mode == ABSENCE and p.value != b"":
            raise InvalidProof("absence proof carries a value")
    try:
        expected = bytes(root_cid)
        pos = p.pos
        for raw in p.nodes:
            if hash_of(raw) != expected:
                raise InvalidProof("hash chain broken at index node")
            entries = decode_index(raw)
            if not entries:
                raise InvalidProof("empty index node")
            if p.mode == MEMBER_BY_POS:
                try:
                    child, base = child_by_pos(entries, pos)
                except IndexError:
                    raise InvalidProof("position outside subtree") from None
                pos -= base
            else:
                child = child_by_key(entries, p.key)
            expected = entries[child].cid
        if hash_of(p.leaf) != expected:
            raise InvalidProof("hash chain broken at leaf")
        if ck.chunk_type(p.leaf) != p.kind:
            raise InvalidProof("leaf kind mismatch")
        return _check_claim(p, leaf_items(p.leaf), pos)
    except InvalidProof:
        raise
    except Exception as e:          # malformed node/leaf payloads
        raise InvalidProof(f"malformed proof: {e}") from e


def _as_proof(proof) -> MembershipProof:
    return (proof if isinstance(proof, MembershipProof)
            else MembershipProof.from_bytes(bytes(proof)))


def verify_member(root_cid: bytes, proof) -> Claim:
    """Stateless single-proof verification: one vectorized hash batch
    over this proof's nodes.  Raises InvalidProof; returns the Claim."""
    p = _as_proof(proof)
    raws = list(p.nodes) + [p.leaf]
    digests = dict(zip(map(id, raws), content_hash_many(raws)))
    return _verify_one(root_cid, p, lambda r: digests[id(r)],
                       lambda r: _decode_index(r, p.kind),
                       lambda r: _leaf_items(p.kind, r))


def verify_member_many(items, *, strict: bool = True,
                       memo: VerifyMemo | None = None):
    """Batched stateless verification of ``[(root_cid, proof), ...]``.

    All *distinct* node/leaf raws across every proof are hashed with one
    ``content_hash_many`` call (one ``fphash_many`` launch on the
    engine's device under fphash cids) and decoded/parsed once — shared
    upper index nodes cost O(1) across the whole batch.  ``strict``
    raises on the first bad proof; otherwise bad entries come back as the
    InvalidProof instance.

    ``memo`` (a VerifyMemo) persists the digest/decoded-node tables
    across calls: an auditor verifying round after round against the
    same trees only hashes nodes it has never seen."""
    proofs = [(bytes(rc), _as_proof(pr)) for rc, pr in items]
    distinct: dict[bytes, None] = {}
    for _, p in proofs:
        for raw in p.nodes:
            distinct[raw] = None
        distinct[p.leaf] = None
    raws = list(distinct)
    if memo is not None:
        memo.refresh()
        memo.add_digests(raws)
        digest = memo.digest
        index_cache = memo.index
        leaf_cache = memo.leaf
    else:
        digest = dict(zip(raws, content_hash_many(raws)))
        index_cache = {}
        leaf_cache = {}

    def decode_index_cached(kind):
        def dec(raw):
            k = (raw, kind)
            if k not in index_cache:
                index_cache[k] = _decode_index(raw, kind)
            return index_cache[k]
        return dec

    def leaf_items_cached(kind):
        def items_of(raw):
            k = (raw, kind)
            if k not in leaf_cache:
                leaf_cache[k] = _leaf_items(kind, raw)
            return leaf_cache[k]
        return items_of

    out = []
    for i, (rc, p) in enumerate(proofs):
        try:
            out.append(_verify_one(rc, p, digest.__getitem__,
                                   decode_index_cached(p.kind),
                                   leaf_items_cached(p.kind)))
        except InvalidProof as e:
            if strict:
                raise InvalidProof(f"proof {i}: {e}") from e
            out.append(e)
    if memo is not None:
        memo.trim()
    return out
