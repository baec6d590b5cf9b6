"""Lineage proofs: the Fig. 2 meta-chunk hash chain, externally
checkable (paper §3.2).

A version's uid is the content hash of its serialized meta chunk, which
embeds the uids it derives from (``bases``) — so the raw meta chunks
along a derivation path from a trusted head down to an ancestor ARE the
proof: ``verify_lineage`` re-hashes each chunk (one vectorized batch),
checks every link is named in its predecessor's ``bases``, and needs no
store.  The verifier learns each intermediate version's full, tamper-
evident record (type, value root, depth, context) for free — the storage
cannot splice in a version outside the history without breaking a hash.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from ..core import chunk as ck
from ..core.fobject import FObject
from ..core.hashing import content_hash_many
from .membership import MAGIC, InvalidProof

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

LINEAGE = 4


@dataclass(frozen=True)
class LineageProof:
    raws: tuple[bytes, ...]        # meta chunk raws, head -> ancestor

    def to_bytes(self) -> bytes:
        parts = [bytes([MAGIC, LINEAGE]), _U16.pack(len(self.raws))]
        for raw in self.raws:
            parts.append(_U32.pack(len(raw)))
            parts.append(raw)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "LineageProof":
        try:
            if data[0] != MAGIC or data[1] != LINEAGE:
                raise InvalidProof("bad magic")
            (n,) = _U16.unpack_from(data, 2)
            i = 4
            raws = []
            for _ in range(n):
                (ln,) = _U32.unpack_from(data, i); i += 4
                raws.append(bytes(data[i:i + ln])); i += ln
                if len(raws[-1]) != ln:
                    raise InvalidProof("truncated chunk")
            if i != len(data):
                raise InvalidProof("bad framing")
        except (struct.error, IndexError) as e:
            raise InvalidProof(f"unparseable proof: {e}") from e
        return cls(tuple(raws))

    @property
    def size(self) -> int:
        return len(self.to_bytes())

    @property
    def distance(self) -> int:
        return len(self.raws) - 1


def lineage_path(store, uid: bytes, ancestor: bytes,
                 max_depth: int = 1 << 30) -> list[bytes] | None:
    """Shortest uid path ``uid -> ... -> ancestor`` through ``bases``,
    walked with one batched ``get_many`` per DAG level (merge commits
    fan out); None when ancestor is not in the history."""
    uid, ancestor = bytes(uid), bytes(ancestor)
    parent: dict[bytes, bytes | None] = {uid: None}
    frontier = [uid]
    d = 0
    while frontier and d <= max_depth:
        if ancestor in parent:
            path = [ancestor]
            while parent[path[-1]] is not None:
                path.append(parent[path[-1]])
            return list(reversed(path))
        nxt: list[bytes] = []
        for u, raw in zip(frontier, store.get_many(frontier)):
            for b in FObject.deserialize(raw, u).bases:
                if b not in parent:
                    parent[b] = u
                    nxt.append(b)
        frontier = nxt
        d += 1
    return None


def prove_lineage(store, uid: bytes, ancestor: bytes) -> LineageProof:
    """Meta-chunk chain for ``ancestor`` in ``uid``'s history; raises
    KeyError when it is not an ancestor."""
    path = lineage_path(store, uid, ancestor)
    if path is None:
        raise KeyError(f"not an ancestor: {bytes(ancestor).hex()[:16]}")
    return LineageProof(tuple(store.get_many(path)))


def verify_lineage(head_uid: bytes, ancestor_uid: bytes,
                   proof) -> list[FObject]:
    """Stateless check that ``ancestor_uid`` is in ``head_uid``'s
    history.  Returns the authenticated FObjects head→ancestor (their
    count minus one is the derivation distance); raises InvalidProof."""
    p = (proof if isinstance(proof, LineageProof)
         else LineageProof.from_bytes(bytes(proof)))
    if not p.raws:
        raise InvalidProof("empty lineage")
    uids = content_hash_many(list(p.raws))
    if uids[0] != bytes(head_uid):
        raise InvalidProof("head uid mismatch")
    if uids[-1] != bytes(ancestor_uid):
        raise InvalidProof("ancestor uid mismatch")
    objs: list[FObject] = []
    for i, raw in enumerate(p.raws):
        try:
            if ck.chunk_type(raw) != ck.META:
                raise InvalidProof("not a meta chunk")
            obj = FObject.deserialize(raw, uids[i])
        except InvalidProof:
            raise
        except Exception as e:
            raise InvalidProof(f"malformed meta chunk: {e}") from e
        if i + 1 < len(p.raws) and uids[i + 1] not in obj.bases:
            raise InvalidProof("hash chain broken: link not in bases")
        objs.append(obj)
    return objs
