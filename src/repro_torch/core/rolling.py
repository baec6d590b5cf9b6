"""Cyclic-polynomial rolling hash for content-defined chunking (paper §4.3.2).

    P(b_1..b_k) = s^{k-1}(h(b_1)) ^ s^{k-2}(h(b_2)) ^ ... ^ s^0(h(b_k))

where ``h`` maps a byte to a pseudo-random word and ``s`` is a 1-bit barrel
rotation within a 32-bit word.  A *pattern* occurs at stream position i when
the low ``q`` bits of P over the window ending at i are all zero; the
expected distance between patterns is 2^q bytes.

This module is the plain PyTorch version of the chunker kernel
(kernels/csrc/chunker.cu): it runs on any device, and the kernel is held to
it bit for bit.  u32 arithmetic is done in int64 and masked to 32 bits,
because PyTorch's CPU backend has no shifts or adds on ``uint32``.

The boundary bitmap is a pure function of the byte stream (the scan window
slides continuously and never resets at cuts), which is the invariant that
makes chunk boundaries stable under local edits and lets incremental commits
splice back into the old chunk sequence (postree.py).
"""
from __future__ import annotations

import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
SEED = 0xF0B

# The plain bitmap works through the stream in segments of this many bytes
# (plus a window halo), so a stream of any length needs bounded memory.
_SEGMENT = 1 << 24


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` holding u32 values, without
    overflowing int64: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding u32 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def byte_table(seed: int = SEED, device=None) -> torch.Tensor:
    """Deterministic h: byte -> u32 table (table[b] = mix32(b + seed*GOLD)),
    as int64."""
    base = torch.arange(256, dtype=torch.int64, device=device)
    return mix32(base + ((seed * GOLD) & MASK32))


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= WORD_BITS
    if r == 0:
        return x
    return ((x << r) | (x >> (WORD_BITS - r))) & MASK32


def rolling_hash(data: torch.Tensor, window: int,
                 seed: int = SEED) -> torch.Tensor:
    """P_i over the window ending at i, for all i >= window-1 (else 0).

    data: uint8[n] tensor.  Returns int64[n] holding u32 values on the same
    device; positions < window-1 are 0 (no full window yet)."""
    h = byte_table(seed, data.device)[data.long()]
    acc = h.clone()
    # P_i = XOR_{j=0..k-1} rotl(h[i-j], j): k vectorized passes.
    for j in range(1, min(window, data.numel())):
        acc[j:] ^= rotl(h[:-j], j)
    if window > 1:
        acc[: window - 1] = 0
    return acc


def boundary_bitmap(data: torch.Tensor, window: int, q: int,
                    seed: int = SEED) -> torch.Tensor:
    """bool[n] on ``data``'s device: True at i iff a pattern ends at byte i
    (paper's predicate ``P & (2^q - 1) == 0``).  Positions without a full
    window are False."""
    n = data.numel()
    out = torch.zeros(n, dtype=torch.bool, device=data.device)
    mask = (1 << q) - 1
    halo = max(window - 1, 0)
    for s in range(0, n, _SEGMENT):
        lo = max(0, s - halo)
        hits = (rolling_hash(data[lo:s + _SEGMENT], window, seed) & mask) == 0
        # the first window-1 hashes of a segment have no full window: in
        # later segments they are the halo and dropped below
        hits[:halo] = False
        out[s:s + _SEGMENT] = hits[s - lo:]
    return out


def rolling_hash_serial(data: bytes, window: int,
                        seed: int = SEED) -> list[int]:
    """O(n) serial recursive form (paper's amortized update rule):
        P_i = s(P_{i-1}) ^ s^k(h(b_{i-k})) ^ h(b_i)
    in Python integers.  Used by tests to validate the vectorized form."""
    table = byte_table(seed).tolist()

    def rot(x: int, r: int) -> int:
        r %= WORD_BITS
        return ((x << r) | (x >> (WORD_BITS - r))) & MASK32

    out = [0] * len(data)
    p = 0
    for i, b in enumerate(data):
        p = rot(p, 1) ^ table[b]
        if i >= window:
            p ^= rot(table[data[i - window]], window)
        if i >= window - 1:
            out[i] = p
    return out
