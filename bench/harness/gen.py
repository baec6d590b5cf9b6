"""Data and key generators of the benchmark, all drawn from a seed.

``make_records`` and the record edits are copied from ``chip_smoke.py``
(``make_records``, ``make_dataset``'s edit runs), the accounts and block
values from its ``seed_accounts`` and ``seeded_blocks``; the zipfian draw is
YCSB's ``ScrambledZipfianGenerator`` (``core/generator``: a zipfian rank over
10^10 items, then FNV-1a 64 of the rank modulo the key count).  They live
here so that a change to the program's own scripts cannot move the
benchmark's traffic.
"""
from __future__ import annotations

import numpy as np

# YCSB ScrambledZipfianGenerator: ITEM_COUNT and its zeta at theta 0.99
_ITEM_COUNT = 10_000_000_000
_ZETAN = 26.46902820178302
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(1099511628211)


def make_records(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n records laid end to end: a 12-byte key "pk%010d", two
    little-endian int32 in [0, 1000) and 100..220 bytes of printable text
    (180 B on average).  Returns the bytes and the n+1 record offsets."""
    rng = np.random.default_rng(seed)
    rec_len = 20 + rng.integers(100, 221, n)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rec_len, out=starts[1:])
    buf = rng.integers(32, 127, int(starts[-1]), dtype=np.uint8)
    hdr = np.empty((n, 20), dtype=np.uint8)
    hdr[:, 0], hdr[:, 1] = ord("p"), ord("k")
    ids = np.arange(n, dtype=np.int64)[:, None]
    hdr[:, 2:12] = ids // 10 ** np.arange(9, -1, -1) % 10 + ord("0")
    hdr[:, 12:20] = rng.integers(0, 1000, (n, 2), dtype="<i4").view(
        np.uint8).reshape(n, 8)
    buf[starts[:-1, None] + np.arange(20)] = hdr
    return buf, starts


def rewrite_records(data: np.ndarray, starts: np.ndarray, idx: np.ndarray,
                    rng) -> list[tuple[int, int, bytes]]:
    """Edits that rewrite records ``idx`` (sorted, distinct) in place: the
    12-byte key kept, the two ints and the text redrawn at the same
    length.  Returns (offset, length, new bytes) runs, one a record or one
    a contiguous run of records."""
    runs = []
    i = 0
    while i < len(idx):
        j = i
        while j + 1 < len(idx) and idx[j + 1] == idx[j] + 1:
            j += 1
        lo, hi = int(starts[idx[i]]), int(starts[idx[j] + 1])
        new = rng.integers(32, 127, hi - lo, dtype=np.uint8)
        keys = starts[idx[i]:idx[j] + 1, None] - lo + np.arange(12)
        new[keys] = data[lo:hi][keys]
        heads = starts[idx[i]:idx[j] + 1] - lo
        ints = rng.integers(0, 1000, (len(heads), 2), dtype="<i4").view(
            np.uint8).reshape(len(heads), 8)
        new[heads[:, None] + np.arange(12, 20)] = ints
        runs.append((lo, hi - lo, new.tobytes()))
        i = j + 1
    return runs


def pick_records(n: int, count: int, pattern: str, rng) -> np.ndarray:
    """``count`` distinct record indices out of ``n``: uniformly spread
    (``scattered``) or one contiguous run at a uniform start
    (``contiguous``)."""
    if pattern == "scattered":
        return np.sort(rng.choice(n, size=count, replace=False))
    if pattern == "contiguous":
        start = int(rng.integers(0, n - count + 1))
        return np.arange(start, start + count)
    raise ValueError(f"unknown edit pattern {pattern!r}")


def zipf_keys(n: int, size: int, rng, theta: float = 0.99) -> np.ndarray:
    """``size`` key ids in [0, n) drawn as YCSB's scrambled zipfian does:
    a zipfian rank over 10^10 items hashed by FNV-1a 64 onto the keys."""
    if theta != 0.99:
        raise ValueError("the precomputed zeta is YCSB's, for theta 0.99")
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + 0.5 ** theta
    eta = (1 - (2.0 / _ITEM_COUNT) ** (1 - theta)) / (1 - zeta2 / _ZETAN)
    u = rng.random(size)
    uz = u * _ZETAN
    rank = (_ITEM_COUNT * (eta * u - eta + 1) ** alpha).astype(np.int64)
    rank = np.where(uz < zeta2, 1, rank)
    rank = np.where(uz < 1.0, 0, rank).astype(np.uint64)
    h = np.full(size, _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= rank & np.uint64(0xFF)
            h *= _FNV_PRIME
            rank >>= np.uint64(8)
        mag = np.abs(h.view(np.int64)).astype(np.uint64)   # Java's abs
    return (mag % np.uint64(n)).astype(np.int64)


def uniform_keys(n: int, size: int, rng) -> np.ndarray:
    return rng.integers(0, n, size)


def draw_keys(dist: str, n: int, size: int, rng) -> np.ndarray:
    if dist == "zipfian":
        return zipf_keys(n, size, rng)
    if dist == "uniform":
        return uniform_keys(n, size, rng)
    raise ValueError(f"unknown key distribution {dist!r}")


def account_key(i: int) -> str:
    """The state key of account ``i`` (chip_smoke's ``key{i}``)."""
    return f"key{i}"
