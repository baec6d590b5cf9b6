"""FObject — the versioned object record (paper Fig. 2, §3.1–3.2).

uid = cid of the serialized meta chunk, so a uid commits to the value *and*
to the full derivation history via the ``bases`` hash chain: the storage
cannot present a version v' outside the history without breaking the hash
chain (tamper evidence, §3.2).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from . import chunk as ck
from ..errors import TamperedChunk

# object type tags: chunkable types reuse chunk kinds; primitives below.
TSTRING = 7
TTUPLE = 8
TINT = 9

CHUNKABLE_TYPES = (ck.BLOB, ck.LIST, ck.SET, ck.MAP)
PRIMITIVE_TYPES = (TSTRING, TTUPLE, TINT)

TYPE_NAMES = {ck.BLOB: "Blob", ck.LIST: "List", ck.SET: "Set", ck.MAP: "Map",
              TSTRING: "String", TTUPLE: "Tuple", TINT: "Integer"}

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


@dataclass(frozen=True)
class FObject:
    type: int
    key: bytes
    data: bytes            # primitives: inline value; chunkables: root cid
    depth: int             # distance to the first version
    bases: tuple[bytes, ...]  # uids this version derives from
    context: bytes = b""   # reserved for the application (commit msg, nonce)
    uid: bytes = b""       # filled after serialization

    def serialize(self) -> bytes:
        parts = [bytes([self.type]),
                 _U32.pack(len(self.key)), self.key,
                 _U32.pack(len(self.data)), self.data,
                 _U64.pack(self.depth),
                 _U16.pack(len(self.bases))]
        parts.extend(self.bases)
        parts.append(_U32.pack(len(self.context)))
        parts.append(self.context)
        return ck.encode_chunk(ck.META, b"".join(parts))

    @classmethod
    def deserialize(cls, raw: bytes, uid: bytes) -> "FObject":
        if ck.chunk_type(raw) != ck.META:
            raise TamperedChunk(uid, "fobject meta chunk has wrong type tag")
        p = ck.chunk_payload(raw)
        t = p[0]
        i = 1
        (kl,) = _U32.unpack_from(p, i); i += 4
        key = p[i:i + kl]; i += kl
        (dl,) = _U32.unpack_from(p, i); i += 4
        data = p[i:i + dl]; i += dl
        (depth,) = _U64.unpack_from(p, i); i += 8
        (nb,) = _U16.unpack_from(p, i); i += 2
        bases = tuple(p[i + 32 * j: i + 32 * (j + 1)] for j in range(nb))
        i += 32 * nb
        (cl,) = _U32.unpack_from(p, i); i += 4
        ctx = p[i:i + cl]
        return cls(t, key, data, depth, bases, ctx, uid)

    @property
    def is_chunkable(self) -> bool:
        return self.type in CHUNKABLE_TYPES

    def type_name(self) -> str:
        return TYPE_NAMES[self.type]


def make_fobject(store, type_: int, key: bytes, data: bytes,
                 bases: tuple[bytes, ...], context: bytes = b"",
                 base_depth: int = -1) -> FObject:
    """Construct, persist and uid-stamp a new FObject meta chunk.

    ``store`` is any StorageBackend; when it is the value's WriteBuffer
    (db.put), the meta chunk rides the same put_many batch as the value's
    tree chunks, so a whole version commits in one store round-trip."""
    obj = FObject(type_, key, data, base_depth + 1, bases, context)
    raw = obj.serialize()
    uid = store.put(raw)
    return FObject(type_, key, data, base_depth + 1, bases, context, uid)


def load_fobject(store, uid: bytes, verify: bool = False) -> FObject:
    """Load a version record; with ``verify`` the meta chunk is re-hashed
    against the uid (the verify-on-get option, counted in StoreStats),
    so a corrupted or substituted version can never deserialize."""
    raw = store.get(uid)
    if verify:
        from .chunk import cid_of
        st = getattr(store, "stats", None)
        ok = cid_of(raw) == bytes(uid)
        if st is not None:
            st.verifies += 1
            st.verify_failures += 0 if ok else 1
        if not ok:
            from ..storage import TamperedChunk
            raise TamperedChunk(bytes(uid), "Get-Meta")
    return FObject.deserialize(raw, uid)
