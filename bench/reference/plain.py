"""The plain reference of ForkBase's encodings, independent of the program.

Frozen copies of the plain versions in ``src/repro_torch`` (the rolling
hash of ``core/rolling.py``, the sponge of ``kernels/ref.py``, the chunk
formats of ``core/chunk.py`` and ``core/fobject.py``, the cut rules of
``core/chunker.py`` and the index build of ``core/postree.py``), written as
one straight pass: a value's whole byte or element stream is cut and
hashed afresh, with no splice, no cache and no store.  It imports nothing
of the program, so a later change to the program cannot move it.

Every function takes a ``device`` on which the hashing runs in plain
PyTorch (the card after a benchmark's window, the CPU in tests).  u32
arithmetic is done in int64 and masked to 32 bits.
"""
from __future__ import annotations

import bisect
import json
import struct
from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
SEED = 0xF0B

# chunk type tags (paper Table 2) and the FObject primitive tags
META, UINDEX, SINDEX, BLOB, LIST, SET, MAP = range(7)
SORTED_KINDS = (SET, MAP)

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


@dataclass(frozen=True)
class Chunking:
    """The chunking a configuration states (paper §4.3.3)."""

    window: int = 48
    q: int = 12
    max_factor: int = 8
    index_r: int = 6
    index_max_factor: int = 8

    @property
    def max_size(self) -> int:
        return self.max_factor << self.q

    @property
    def index_max_fanout(self) -> int:
        return self.index_max_factor << self.index_r


# ------------------------------------------------------------ rolling hash

def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= 32
    return x if r == 0 else ((x << r) | (x >> (32 - r))) & MASK32


_SEGMENT = 1 << 24


def pattern_ends(data: np.ndarray, window: int, q: int,
                 device) -> np.ndarray:
    """Stream positions just after each byte at which the cyclic
    polynomial over the ``window`` bytes ending there has its low ``q``
    bits zero (positions without a full window never match)."""
    n = int(data.shape[0])
    table = mix32(torch.arange(256, dtype=torch.int64, device=device)
                  + ((SEED * GOLD) & MASK32))
    mask = (1 << q) - 1
    halo = window - 1
    out = []
    for s in range(0, n, _SEGMENT):
        lo = max(0, s - halo)
        seg = torch.from_numpy(np.ascontiguousarray(
            data[lo:s + _SEGMENT])).to(device)
        h = table[seg.long()]
        acc = h.clone()
        for j in range(1, min(window, seg.numel())):
            acc[j:] ^= _rotl(h[:-j], j)
        hits = (acc & mask) == 0
        hits[:halo] = False             # no full window (or the halo)
        idx = torch.nonzero(hits).flatten().cpu().numpy()
        out.append(idx + lo + 1)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


# ------------------------------------------------------------------ fphash

_BLOCK = 4096
_STATE = (8, 128)
_SWEEP = 1 << 27


def _round(state: torch.Tensor) -> torch.Tensor:
    state = mul32(state, GOLD)
    state = state ^ (((state >> 13) | (state << 19)) & MASK32)
    state = (state + torch.roll(state, 1, dims=-1)) & MASK32
    state = state ^ (((state >> 7) | (state << 25)) & MASK32)
    return (state + torch.roll(state, 1, dims=-2)) & MASK32


def _digests(data: torch.Tensor, offsets: torch.Tensor,
             lengths: torch.Tensor, nb: int) -> torch.Tensor:
    m = lengths.numel()
    pos = torch.arange(nb * _BLOCK, device=data.device)
    valid = pos[None, :] < lengths[:, None]
    idx = (offsets[:, None] + pos[None, :]).clamp_(max=max(data.numel() - 1,
                                                           0))
    b = (torch.where(valid, data[idx].long(), 0) if data.numel()
         else torch.zeros(valid.shape, dtype=torch.int64, device=data.device))
    b = b.view(m, nb, 1024, 4)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    init = mix32(torch.arange(1024, dtype=torch.int64, device=data.device)
                 .reshape(_STATE) + GOLD)
    state = init.expand((m,) + _STATE)
    for blk in range(nb):
        state = state ^ words[:, blk].view((m,) + _STATE)
        for _ in range(4):
            state = _round(state)
    state = _round(_round(state ^ (lengths & MASK32)[:, None, None]))
    while state.shape[-1] > 1:
        half = state.shape[-1] // 2
        state = state[..., :half] ^ state[..., half:]
    lane = torch.arange(8, dtype=torch.int64, device=data.device)
    return mix32(state[..., 0] ^ mul32(lane, GOLD))


def cids(raws: list[bytes], device) -> list[bytes]:
    """The 32-byte fphash cid of each byte string."""
    if not raws:
        return []
    lengths = np.fromiter(map(len, raws), dtype=np.int64, count=len(raws))
    offsets = np.zeros_like(lengths)
    np.cumsum(lengths[:-1], out=offsets[1:])
    data = torch.from_numpy(np.frombuffer(b"".join(raws) or b"\0",
                                          dtype=np.uint8).copy()).to(device)
    off = torch.from_numpy(offsets).to(device)
    ln = torch.from_numpy(lengths).to(device)
    out = torch.empty((len(raws), 8), dtype=torch.int64, device=device)
    nbs = ((ln + _BLOCK - 1) // _BLOCK).clamp_(min=1)
    for nb in torch.unique(nbs).tolist():
        rows = torch.nonzero(nbs == nb).flatten()
        step = max(1, _SWEEP // (nb * _BLOCK))
        for s in range(0, rows.numel(), step):
            sub = rows[s:s + step]
            out[sub] = _digests(data, off[sub], ln[sub], nb)
    raw = out.cpu().numpy().astype("<u4").tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def cid(raw: bytes, device) -> bytes:
    return cids([raw], device)[0]


# ----------------------------------------------------------- chunk formats

def pack_kv(k: bytes, v: bytes) -> bytes:
    return _U32.pack(len(k)) + k + _U32.pack(len(v)) + v


def unpack_kv(payload: bytes) -> list[tuple[bytes, bytes]]:
    out, i = [], 0
    while i < len(payload):
        (kl,) = _U32.unpack_from(payload, i)
        k = payload[i + 4:i + 4 + kl]
        i += 4 + kl
        (vl,) = _U32.unpack_from(payload, i)
        out.append((k, payload[i + 4:i + 4 + vl]))
        i += 4 + vl
    return out


def _index_node(sorted_kind: bool, group: list[tuple]) -> bytes:
    parts = [bytes([SINDEX if sorted_kind else UINDEX])]
    for c, n, k in group:
        parts += [c, _U64.pack(n)]
        if sorted_kind:
            parts += [_U32.pack(len(k)), k]
    return b"".join(parts)


def decode_index(raw: bytes) -> list[tuple[bytes, int, bytes | None]]:
    """(child cid, items below it, max key or None) of an index node."""
    sorted_kind = raw[0] == SINDEX
    p, out, i = raw[1:], [], 0
    while i < len(p):
        c = p[i:i + 32]
        (n,) = _U64.unpack_from(p, i + 32)
        i += 40
        k = None
        if sorted_kind:
            (kl,) = _U32.unpack_from(p, i)
            k = p[i + 4:i + 4 + kl]
            i += 4 + kl
        out.append((c, n, k))
    return out


def _root(kind: int, leaves: list[tuple], ch: Chunking, device) -> bytes:
    """Root cid over leaf entries (cid, count, max key), built level by
    level: a node ends after a child whose cid's first byte has its low
    ``index_r`` bits zero, or at the fan-out cap."""
    sorted_kind = kind in SORTED_KINDS
    mask = (1 << ch.index_r) - 1
    level = leaves
    while len(level) > 1:
        groups, cur = [], []
        for e in level:
            cur.append(e)
            if (e[0][0] & mask) == 0 or len(cur) >= ch.index_max_fanout:
                groups.append(cur)
                cur = []
        if cur:
            groups.append(cur)
        raws = [_index_node(sorted_kind, g) for g in groups]
        level = [(c, sum(e[1] for e in g), g[-1][2])
                 for c, g in zip(cids(raws, device), groups)]
    return level[0][0]


def blob_root(data: np.ndarray, ch: Chunking, device) -> bytes:
    """Root cid of a Blob holding ``data`` (uint8)."""
    n = int(data.shape[0])
    if n == 0:
        return cid(bytes([BLOB]), device)
    hits = pattern_ends(data, ch.window, ch.q, device).tolist()
    cuts, start, i = [], 0, 0
    while start < n:
        while i < len(hits) and hits[i] <= start:
            i += 1
        nxt = hits[i] if i < len(hits) else n
        nxt = min(nxt, start + ch.max_size, n)
        cuts.append(nxt)
        start = nxt
    bounds = list(zip([0] + cuts[:-1], cuts))
    raws = [bytes([BLOB]) + data[a:b].tobytes() for a, b in bounds]
    leaves = [(c, b - a, None) for c, (a, b) in zip(cids(raws, device),
                                                     bounds)]
    return _root(BLOB, leaves, ch, device)


def map_root(items: list[tuple[bytes, bytes]], ch: Chunking,
             device) -> bytes:
    """Root cid of a Map holding ``items``, sorted by key."""
    if not items:
        return cid(bytes([MAP]), device)
    els = [pack_kv(k, v) for k, v in items]
    ends = np.cumsum(np.fromiter(map(len, els), dtype=np.int64,
                                 count=len(els)))
    stream = np.frombuffer(b"".join(els), dtype=np.uint8)
    hits = pattern_ends(stream, ch.window, ch.q, device)
    el_of_hit = np.searchsorted(ends, hits, side="left")
    cut_after = np.unique(el_of_hit[el_of_hit < len(els)]) + 1
    cuts, start_el, start_byte, i = [], 0, 0, 0
    while start_el < len(els):
        while i < len(cut_after) and cut_after[i] <= start_el:
            i += 1
        nxt = int(cut_after[i]) if i < len(cut_after) else len(els)
        if int(ends[nxt - 1]) - start_byte > ch.max_size:
            j = int(np.searchsorted(ends, start_byte + ch.max_size,
                                    side="right"))
            nxt = min(max(j, start_el + 1), nxt)
        cuts.append(nxt)
        start_el, start_byte = nxt, int(ends[nxt - 1])
    bounds = list(zip([0] + cuts[:-1], cuts))
    raws = [bytes([MAP]) + b"".join(els[a:b]) for a, b in bounds]
    leaves = [(c, b - a, items[b - 1][0])
              for c, (a, b) in zip(cids(raws, device), bounds)]
    return _root(MAP, leaves, ch, device)


# ---------------------------------------------------------------- versions

@dataclass(frozen=True)
class Meta:
    """A version record (the FObject meta chunk), fields as stored."""

    type: int
    key: bytes
    data: bytes
    depth: int
    bases: tuple[bytes, ...]
    context: bytes

    def encode(self) -> bytes:
        parts = [bytes([META, self.type]), _U32.pack(len(self.key)),
                 self.key, _U32.pack(len(self.data)), self.data,
                 _U64.pack(self.depth), _U16.pack(len(self.bases)),
                 *self.bases, _U32.pack(len(self.context)), self.context]
        return b"".join(parts)

    @classmethod
    def decode(cls, raw: bytes) -> "Meta":
        if raw[0] != META:
            raise ValueError("not a meta chunk")
        p, i = raw[1:], 1
        t = p[0]
        (kl,) = _U32.unpack_from(p, i)
        key = p[i + 4:i + 4 + kl]
        i += 4 + kl
        (dl,) = _U32.unpack_from(p, i)
        data = p[i + 4:i + 4 + dl]
        i += 4 + dl
        (depth,) = _U64.unpack_from(p, i)
        (nb,) = _U16.unpack_from(p, i + 8)
        i += 10
        bases = tuple(p[i + 32 * j:i + 32 * (j + 1)] for j in range(nb))
        i += 32 * nb
        (cl,) = _U32.unpack_from(p, i)
        ctx = p[i + 4:i + 4 + cl]
        if i + 4 + cl != len(p):
            raise ValueError("meta chunk framing")
        return cls(t, key, data, depth, bases, ctx)


def height_context(height: int) -> bytes:
    """The context a ledger block and its state fold carry."""
    return json.dumps({"height": height}).encode()


def block_txs(keys: list[str], contract: str = "kv") -> bytes:
    """The ``txs`` entry of a block: every write of the block, in order."""
    return json.dumps([(contract, "put", k) for k in keys]).encode()


# ------------------------------------------------------------------ proofs

class Rejected(Exception):
    """A proof that the plain verifier does not accept."""


def _frames(data: bytes, i: int, n: int) -> tuple[list[bytes], int]:
    out = []
    for _ in range(n):
        (ln,) = _U32.unpack_from(data, i)
        out.append(data[i + 4:i + 4 + ln])
        if len(out[-1]) != ln:
            raise Rejected("truncated frame")
        i += 4 + ln
    return out, i


def lineage_raws(proof: bytes) -> list[bytes]:
    if proof[:2] != bytes([0xFB, 4]):
        raise Rejected("not a lineage proof")
    (n,) = _U16.unpack_from(proof, 2)
    raws, i = _frames(proof, 4, n)
    if i != len(proof) or not raws:
        raise Rejected("lineage framing")
    return raws


def member_by_key(root: bytes, proof: bytes, key: bytes,
                  device) -> bytes:
    """The value a by-key Map membership proof binds to ``key`` under
    ``root``; raises Rejected when any link or the claim fails."""
    if proof[0] != 0xFB or proof[1] != 2 or proof[2] != MAP:
        raise Rejected("not a by-key map proof")
    i = 3 + 8
    (kl,) = _U32.unpack_from(proof, i)
    pkey = proof[i + 4:i + 4 + kl]
    i += 4 + kl
    (vl,) = _U32.unpack_from(proof, i)
    value = proof[i + 4:i + 4 + vl]
    i += 4 + vl
    (nn,) = _U16.unpack_from(proof, i)
    nodes, i = _frames(proof, i + 2, nn)
    (leaf,), i = _frames(proof, i, 1)
    if i != len(proof) or pkey != key:
        raise Rejected("proof framing or key")
    digests = cids(nodes + [leaf], device)
    expected = root
    for raw, d in zip(nodes, digests):
        if d != expected or raw[0] != SINDEX:
            raise Rejected("hash chain broken at an index node")
        entries = decode_index(raw)
        j = min(bisect.bisect_left([e[2] for e in entries], key),
                len(entries) - 1)
        expected = entries[j][0]
    if digests[-1] != expected or leaf[0] != MAP:
        raise Rejected("hash chain broken at the leaf")
    got = dict(unpack_kv(leaf[1:])).get(key)
    if got is None or got != value:
        raise Rejected("the leaf does not hold the claimed entry")
    return value
