"""Head attestations: a compact commitment to a branch table.

``attest_heads`` Merkle-izes every (key, branch tag, head uid) triple —
tagged branches plus untagged fork-on-conflict heads — into one root
digest, optionally HMAC-signed.  The attestation is the light client's
trust anchor (the substrate paper's auditor use-case): ``prove_head``
yields an O(log heads) audit path showing a single head is committed to
by the root, and from that head uid, lineage and membership proofs
authenticate everything beneath it — value roots, elements, history —
with no store access anywhere.

The tree is a plain binary Merkle tree over the sorted entry encodings
(domain-separated leaf/node hashes, odd nodes promoted), deliberately
independent of the POS-Tree: a branch table is small, mutates wholesale
per attestation epoch, and needs nothing content-defined.
"""
from __future__ import annotations

import hmac as _hmac
import struct
from dataclasses import dataclass

from ..core.hashing import content_hash, content_hash_many
from .membership import MAGIC, InvalidProof

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

ATTESTATION = 5
HEAD_PROOF = 6

UB_TAG = "\x00ub"       # pseudo-tag for untagged (FoC) heads


def _lv(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


def encode_entry(key: bytes, tag: str, uid: bytes) -> bytes:
    return _lv(bytes(key)) + _lv(tag.encode()) + bytes(uid)


def decode_entry(e: bytes) -> tuple[bytes, str, bytes]:
    """Parse one committed head entry.  Every framing length is
    validated and every parse failure surfaces as InvalidProof — a
    malformed entry inside an otherwise-valid attestation (e.g. a buggy
    or hostile attester committing garbage) must not leak struct.error
    or silently-truncated fields through ``verify_head``."""
    try:
        (kl,) = _U32.unpack_from(e, 0)
        key = e[4:4 + kl]
        if len(key) != kl:
            raise InvalidProof("truncated entry key")
        i = 4 + kl
        (tl,) = _U32.unpack_from(e, i)
        tag = e[i + 4:i + 4 + tl]
        if len(tag) != tl:
            raise InvalidProof("truncated entry tag")
        uid = e[i + 4 + tl:]
        if len(uid) != 32:
            raise InvalidProof("bad entry uid")
        return bytes(key), tag.decode(), bytes(uid)
    except InvalidProof:
        raise
    except (struct.error, IndexError, UnicodeDecodeError) as exc:
        raise InvalidProof(f"malformed head entry: {exc}") from exc


def head_entries(branches) -> list[bytes]:
    """Deterministic serialized entry list of a BranchTable: every tagged
    head plus every untagged (FoC) head that is not merely an alias of a
    tagged one."""
    out = []
    for key in branches.keys():
        tb = branches.tagged(key)
        for tag, uid in tb.items():
            out.append(encode_entry(key, tag, uid))
        aliased = set(tb.values())
        for uid in branches.untagged(key):
            if uid not in aliased:
                out.append(encode_entry(key, UB_TAG, uid))
    return sorted(out)


# ------------------------------------------------------------- merkle tree

def leaf_hash(entry: bytes) -> bytes:
    return content_hash(b"\x00" + entry)


def node_hash(left: bytes, right: bytes) -> bytes:
    return content_hash(b"\x01" + left + right)


EMPTY_ROOT = b"\x00" * 32


def merkle_root(leaves: list[bytes]) -> bytes:
    """Root over pre-hashed leaf digests (odd node promoted)."""
    if not leaves:
        return EMPTY_ROOT
    level = list(leaves)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(node_hash(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _merkle_path(leaves: list[bytes], index: int) -> list[bytes]:
    sibs = []
    level = list(leaves)
    i = index
    while len(level) > 1:
        sib = i ^ 1
        if sib < len(level):
            sibs.append(level[sib])
        nxt = []
        for j in range(0, len(level) - 1, 2):
            nxt.append(node_hash(level[j], level[j + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        i //= 2
    return sibs


# -------------------------------------------------------------- attestation

@dataclass(frozen=True)
class Attestation:
    root: bytes
    count: int                    # number of committed head entries
    context: bytes = b""          # epoch / node id / app nonce
    sig: bytes = b""              # HMAC over root|count|context

    def signing_bytes(self) -> bytes:
        return self.root + _U32.pack(self.count) + self.context

    def to_bytes(self) -> bytes:
        return (bytes([MAGIC, ATTESTATION]) + self.root
                + _U32.pack(self.count) + _lv(self.context) + _lv(self.sig))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Attestation":
        try:
            if data[0] != MAGIC or data[1] != ATTESTATION:
                raise InvalidProof("bad magic")
            root = bytes(data[2:34])
            if len(root) != 32:
                raise InvalidProof("truncated root")
            (count,) = _U32.unpack_from(data, 34)
            (cl,) = _U32.unpack_from(data, 38)
            ctx = bytes(data[42:42 + cl])
            if len(ctx) != cl:
                raise InvalidProof("truncated context")
            i = 42 + cl
            (sl,) = _U32.unpack_from(data, i)
            sig = bytes(data[i + 4:i + 4 + sl])
            if len(sig) != sl or i + 4 + sl != len(data):
                raise InvalidProof("bad framing")
        except (struct.error, IndexError) as e:
            raise InvalidProof(f"unparseable attestation: {e}") from e
        return cls(root, count, ctx, sig)


def sign(att: Attestation, secret: bytes) -> Attestation:
    sig = _hmac.new(secret, att.signing_bytes(), "sha256").digest()
    return Attestation(att.root, att.count, att.context, sig)


def verify_attestation(att, secret: bytes | None = None) -> Attestation:
    """Parse + (when ``secret`` given) authenticate the signature."""
    a = (att if isinstance(att, Attestation)
         else Attestation.from_bytes(bytes(att)))
    if secret is not None:
        want = _hmac.new(secret, a.signing_bytes(), "sha256").digest()
        if not _hmac.compare_digest(want, a.sig):
            raise InvalidProof("attestation signature mismatch")
    return a


def attest_heads(branches, context: bytes = b"",
                 secret: bytes | None = None) -> Attestation:
    entries = head_entries(branches)
    leaves = content_hash_many([b"\x00" + e for e in entries])
    att = Attestation(merkle_root(leaves), len(entries), bytes(context))
    return sign(att, secret) if secret is not None else att


# -------------------------------------------------------------- head proofs

@dataclass(frozen=True)
class HeadProof:
    index: int
    entry: bytes                  # encode_entry(key, tag, uid)
    siblings: tuple[bytes, ...]

    def to_bytes(self) -> bytes:
        return (bytes([MAGIC, HEAD_PROOF]) + _U32.pack(self.index)
                + _lv(self.entry) + _U16.pack(len(self.siblings))
                + b"".join(self.siblings))

    @classmethod
    def from_bytes(cls, data: bytes) -> "HeadProof":
        try:
            if data[0] != MAGIC or data[1] != HEAD_PROOF:
                raise InvalidProof("bad magic")
            (index,) = _U32.unpack_from(data, 2)
            (el,) = _U32.unpack_from(data, 6)
            entry = bytes(data[10:10 + el])
            if len(entry) != el:
                raise InvalidProof("truncated entry")
            i = 10 + el
            (ns,) = _U16.unpack_from(data, i)
            i += 2
            sibs = []
            for _ in range(ns):
                sibs.append(bytes(data[i:i + 32])); i += 32
                if len(sibs[-1]) != 32:
                    raise InvalidProof("truncated sibling")
            if i != len(data):
                raise InvalidProof("bad framing")
        except (struct.error, IndexError) as e:
            raise InvalidProof(f"unparseable head proof: {e}") from e
        return cls(index, entry, tuple(sibs))

    @property
    def size(self) -> int:
        return len(self.to_bytes())


def entry_leaves(entries: list[bytes]) -> list[bytes]:
    """Leaf digests for a serialized entry list — ONE hash batch."""
    return content_hash_many([b"\x00" + e for e in entries])


def prove_entry(entries: list[bytes], leaves: list[bytes],
                entry: bytes) -> HeadProof:
    """Audit path for one entry against precomputed (entries, leaves) —
    the auditor's batched path: many proofs, one tree, one hash batch."""
    try:
        index = entries.index(entry)
    except ValueError:
        raise KeyError(entry) from None
    return HeadProof(index, entry, tuple(_merkle_path(leaves, index)))


def prove_head(branches, key: bytes, tag: str | None = None,
               uid: bytes | None = None) -> HeadProof:
    """Audit path for one head: a tagged branch (``tag``) or an untagged
    FoC head (``uid``)."""
    key = bytes(key)
    if tag is None:
        if uid is None:
            raise ValueError("need tag or uid")
        tag = UB_TAG
        entry = encode_entry(key, tag, uid)
    else:
        head = branches.head(key, tag)
        if head is None:
            raise KeyError(tag)
        entry = encode_entry(key, tag, head)
    entries = head_entries(branches)
    return prove_entry(entries, entry_leaves(entries), entry)


def verify_head(attestation, proof,
                secret: bytes | None = None) -> tuple[bytes, str, bytes]:
    """Stateless: does the attestation commit to this head?  Returns the
    authenticated (key, tag, head uid); raises InvalidProof.  The sibling
    walk is replayed against the attested entry COUNT, so a forged count,
    index, or path length cannot reach the committed root."""
    att = verify_attestation(attestation, secret)
    p = (proof if isinstance(proof, HeadProof)
         else HeadProof.from_bytes(bytes(proof)))
    if not (0 <= p.index < att.count):
        raise InvalidProof("index outside attested entry count")
    digest = leaf_hash(p.entry)
    i, width = p.index, att.count
    sibs = list(p.siblings)
    while width > 1:
        sib = i ^ 1
        if sib < width:
            if not sibs:
                raise InvalidProof("audit path too short")
            other = sibs.pop(0)
            digest = (node_hash(digest, other) if i % 2 == 0
                      else node_hash(other, digest))
        i //= 2
        width = (width + 1) // 2
    if sibs:
        raise InvalidProof("audit path too long")
    if digest != att.root:
        raise InvalidProof("head not committed by attestation root")
    return decode_entry(p.entry)
