"""Chunk wire format (paper §4.2, Table 2).

A chunk is the basic storage unit: 1 type byte + payload; its cid is the
content hash of the full serialized bytes, so equal content <=> equal cid
(the dedup + tamper-evidence invariant).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from .hashing import content_hash

# chunk type tags (Table 2)
META = 0
UINDEX = 1
SINDEX = 2
BLOB = 3
LIST = 4
SET = 5
MAP = 6

CHUNK_TYPE_NAMES = {META: "Meta", UINDEX: "UIndex", SINDEX: "SIndex",
                    BLOB: "Blob", LIST: "List", SET: "Set", MAP: "Map"}

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def encode_chunk(ctype: int, payload: bytes) -> bytes:
    return bytes([ctype]) + payload


def chunk_type(raw: bytes) -> int:
    return raw[0]


def chunk_payload(raw: bytes) -> bytes:
    return raw[1:]


def cid_of(raw: bytes) -> bytes:
    return content_hash(raw)


# ---------------------------------------------------------------- elements

def pack_lv(b: bytes) -> bytes:
    """length-value encoding for one element."""
    return _U32.pack(len(b)) + b


def pack_kv(k: bytes, v: bytes) -> bytes:
    return _U32.pack(len(k)) + k + _U32.pack(len(v)) + v


def unpack_lv_stream(payload: bytes) -> list[bytes]:
    out = []
    i, n = 0, len(payload)
    while i < n:
        (ln,) = _U32.unpack_from(payload, i)
        i += 4
        out.append(payload[i:i + ln])
        i += ln
    return out


def unpack_kv_stream(payload: bytes) -> list[tuple[bytes, bytes]]:
    out = []
    i, n = 0, len(payload)
    while i < n:
        (kl,) = _U32.unpack_from(payload, i)
        i += 4
        k = payload[i:i + kl]
        i += kl
        (vl,) = _U32.unpack_from(payload, i)
        i += 4
        out.append((k, payload[i:i + vl]))
        i += vl
    return out


def kv_key(elem: bytes) -> bytes:
    """key of a serialized Map element (for SIndex split keys)."""
    (kl,) = _U32.unpack_from(elem, 0)
    return elem[4:4 + kl]


# ---------------------------------------------------------------- index nodes

@dataclass(frozen=True)
class Entry:
    """One index entry: child cid + subtree item count (+ max key for sorted
    types).  count is in *base items*: bytes for Blob, elements otherwise."""

    cid: bytes
    count: int
    key: bytes | None = None


def encode_uindex(entries: list[Entry]) -> bytes:
    parts = []
    for e in entries:
        parts.append(e.cid)
        parts.append(_U64.pack(e.count))
    return encode_chunk(UINDEX, b"".join(parts))


def decode_uindex(payload: bytes) -> list[Entry]:
    out = []
    i, n = 0, len(payload)
    while i < n:
        cid = payload[i:i + 32]
        i += 32
        (cnt,) = _U64.unpack_from(payload, i)
        i += 8
        out.append(Entry(cid, cnt))
    return out


def encode_sindex(entries: list[Entry]) -> bytes:
    parts = []
    for e in entries:
        parts.append(e.cid)
        parts.append(_U64.pack(e.count))
        parts.append(pack_lv(e.key or b""))
    return encode_chunk(SINDEX, b"".join(parts))


def decode_sindex(payload: bytes) -> list[Entry]:
    out = []
    i, n = 0, len(payload)
    while i < n:
        cid = payload[i:i + 32]
        i += 32
        (cnt,) = _U64.unpack_from(payload, i)
        i += 8
        (kl,) = _U32.unpack_from(payload, i)
        i += 4
        k = payload[i:i + kl]
        i += kl
        out.append(Entry(cid, cnt, k))
    return out
