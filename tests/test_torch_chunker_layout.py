"""A numpy model of the block schedule of the boundary-bitmap CUDA kernel
(src/repro_torch/kernels/csrc/chunker.cu), held bit for bit to the JAX
package's numpy bitmap and to the port's plain version, on the CPU.

The kernel runs only on the card; this model runs its schedule step for
step, for every thread of every block at once:

  * a tile of 8192 positions per block of 128 threads, staged with the 128
    bytes before it as h() words in a shared array padded by one word every
    64 (pad(p) = p + p // 64); the padding words hold junk;
  * the stage read as 520 granule pairs: the two aligned 16-byte granules
    that hold 16 stage positions, at every misalignment 0..15 of the stream
    start, their bytes shifted into place by word selection and a funnel
    shift; a pair not wholly inside [0, n) read byte by byte, bytes outside
    the stream staged as 0;
  * runs of 64 positions a thread: a direct window sum walked through the
    padded indices, then 63 O(1) updates whose read of h_{i-k} crosses one
    padding word at step c = ((k - 1) & 63) + 1;
  * the 64 flags packed into 16 little-endian words, the positions < k-1
    cleared after the loop in the runs that meet them.

Tolerance: none, every bitmap is compared bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import rolling as ref_rolling
from repro_torch.core import rolling

THREADS, RUN = 128, 64
TILE = THREADS * RUN
PRE = 128
STAGE = PRE + TILE
GRANULES = STAGE // 16
SEED_TERM = np.uint32((rolling.SEED * rolling.GOLD) & rolling.MASK32)
N_GRID = [1, 47, 48, 127, 128, 8191, 8192, 8193, 16_385, 40_000]
WQ_GRID = [(48, 12), (16, 8), (128, 10), (4, 4), (1, 0)]
OFFSETS = [0, 1, 7, 15]


def pad(p):
    return p + (p >> 6)


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _rotl(x, r):
    r %= 32
    if r == 0:
        return x
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: the low word of (hi:lo) >> sh."""
    if sh == 0:
        return lo
    return (lo >> np.uint32(sh)) | (hi << np.uint32(32 - sh))


def _stage(mem, off, n, blocks):
    """The staged words (blocks, 16 per granule) as the kernel reads them
    from the stream mem[off:off + n], whose start lies at off mod 16 from
    an aligned address; and the lowest and highest index of mem read."""
    a16 = off & 15
    s0 = (np.arange(blocks)[:, None] * TILE - PRE
          + 16 * np.arange(GRANULES)[None, :])             # (B, G)
    end = s0 + 32 - a16 if a16 else s0 + 16
    fast = (s0 - a16 >= 0) & (end <= n)
    # fast: the aligned granules at mem[off + s0 - a16], two when a16 > 0
    width = 32 if a16 else 16
    idx = (off + s0 - a16)[..., None] + np.arange(width)
    got = mem[np.where(fast[..., None], idx, 0)].astype(np.uint8)
    v = np.ascontiguousarray(got).view("<u4").astype(np.uint32)
    if a16:
        q, sh = a16 >> 2, 8 * (a16 & 3)
        w = v[..., q:q + 5]                                # v[q + i]
        v = np.stack([_funnel_r(w[..., i], w[..., i + 1], sh)
                      for i in range(4)], axis=-1)
    fast_bytes = np.ascontiguousarray(v).view(np.uint8)   # (B, G, 16)
    # slow: byte by byte, 0 outside [0, n)
    s = s0[..., None] + np.arange(16)
    inside = (s >= 0) & (s < n)
    slow_bytes = np.where(inside, mem[np.where(inside, off + s, 0)], 0)
    raw = np.where(fast[..., None], fast_bytes, slow_bytes).astype(np.uint32)
    read = np.concatenate([idx[fast].ravel(),
                           (off + s)[~fast[..., None] & inside]])
    with np.errstate(over="ignore"):
        words = _mix32(raw + SEED_TERM)                    # (B, G, 16)
    return words.reshape(blocks, STAGE), read


def kernel_model(mem: np.ndarray, off: int, n: int, window: int, q: int):
    """Bitmap of mem[off:off + n] by the kernel's schedule; and every index
    of mem it read."""
    blocks = max(1, -(-n // TILE))
    staged, read = _stage(mem, off, n, blocks)
    rng = np.random.default_rng(n + window)
    h = rng.integers(0, 2**32, (blocks, pad(STAGE - 1) + 1),
                     dtype=np.uint64).astype(np.uint32)   # junk in pads
    p = np.arange(STAGE)
    h[:, pad(p)] = staged
    rows = np.arange(blocks)[:, None]
    t = np.arange(THREADS)[None, :]
    at = PRE + RUN * t                                     # (1, T)
    cur = pad(at)
    mask = np.uint32((1 << q) - 1)
    with np.errstate(over="ignore"):
        acc = h[rows, cur]
        for j in range(1, min(window, 65)):
            acc = acc ^ _rotl(h[rows, cur - 1 - j], j)
        for j in range(65, window):
            acc = acc ^ _rotl(h[rows, cur - 2 - j], j)
        old = pad(at - window)
        c = ((window - 1) & 63) + 1
        words = np.zeros((blocks, THREADS, RUN // 4), dtype=np.uint32)
        words[..., 0] = (acc & mask) == 0
        for i in range(1, RUN):
            o = h[rows, old + i + (i >= c)]
            acc = _rotl(acc, 1) ^ h[rows, cur + i] ^ _rotl(o, window)
            hit = ((acc & mask) == 0).astype(np.uint32)
            words[..., i >> 2] |= hit << np.uint32(8 * (i & 3))
    g0 = (np.arange(blocks)[:, None] * TILE + RUN * t)     # (B, T)
    halo = window - 1
    for b, th in zip(*np.nonzero(g0 < halo)):
        for i in range(RUN):
            if g0[b, th] + i < halo:
                words[b, th, i >> 2] &= ~np.uint32(0xFF << (8 * (i & 3)))
    flags = np.ascontiguousarray(words.astype("<u4")).view(np.uint8)
    return flags.reshape(-1)[:n].astype(bool), read


@pytest.mark.parametrize("n", N_GRID)
@pytest.mark.parametrize("wq", WQ_GRID)
def test_block_schedule_matches_references(n, wq):
    """The stream at offsets 0, 1, 7 and 15 of a larger buffer of random
    bytes: a read outside the stream would change the bitmap, and is also
    caught by the indices read."""
    w, q = wq
    rng = np.random.default_rng(n * 131 + w)
    mem = rng.integers(0, 256, 16 + n + 48, dtype=np.uint8)
    for off in OFFSETS:
        data = mem[off:off + n]
        want = ref_rolling.boundary_bitmap(data, w, q)
        plain = rolling.boundary_bitmap(torch.from_numpy(data.copy()), w, q)
        np.testing.assert_array_equal(plain.numpy(), want)
        got, read = kernel_model(mem, off, n, w, q)
        np.testing.assert_array_equal(got, want, err_msg=f"offset {off}")
        assert read.size and read.min() >= off and read.max() < off + n


def test_padded_reads_of_a_warp_hit_32_banks():
    """At every step of the direct sum and of the update, the 32 threads of
    a warp read 32 different banks."""
    t = np.arange(32)
    cur = pad(PRE + RUN * t)
    for window in (1, 4, 16, 48, 64, 65, 127, 128):
        for j in range(1, window):
            at_j = cur - 1 - j if j <= 64 else cur - 2 - j
            assert len(set(at_j % 32)) == 32
            np.testing.assert_array_equal(at_j, pad(PRE + RUN * t - j))
        old = pad(PRE + RUN * t - window)
        c = ((window - 1) & 63) + 1
        for i in range(RUN):
            idx = old + i + (i >= c)
            np.testing.assert_array_equal(
                idx, pad(PRE + RUN * t - window + i))
            assert len(set(idx % 32)) == 32
            assert len(set((cur + i) % 32)) == 32
