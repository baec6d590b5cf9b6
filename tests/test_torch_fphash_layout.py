"""A numpy model of the warp schedule of the fphash CUDA kernel
(src/repro_torch/kernels/csrc/fphash.cu), held bit for bit to the JAX
package's numpy path and to the port's plain version, on the CPU.

The kernel runs only on the card; this model runs its schedule step for
step, for a batch of chunks at once:

  * 32 lanes x 32 registers: lane l holds state word (r, c = l + 32 j) in
    register s[r][j];
  * the lane roll as 4 shuffles a row from lane l - 1, lane 0 taking the
    value of register j - 1; the row roll as a renaming of registers;
  * each 4 KB block staged as 257 granules of 16 bytes from the chunk's
    start rounded down to 16, each granule copying only the bytes before
    the chunk's end and zero-filling the rest (cp.async with src-size);
  * words funnel-shifted from two aligned u32s of the stage, at every
    misalignment 0..15;
  * the warp's XOR fold by butterfly shuffles, lanes 0..7 writing.

Tolerance: none, every digest is compared bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.kernels.fphash import _fphash_many_host
from repro_torch.kernels.ref import fphash_many_ref

GOLD = np.uint32(0x9E3779B9)
LANES = np.arange(32)
BLOCK = 4096
GRANULES = BLOCK // 16 + 1
FP_LENGTHS = [0, 1, 31, 4095, 4096, 4097, 12288, 32768, 32769, 65536]
LENGTHS = FP_LENGTHS + [3, 5, 32_800]


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _rotr(x, r):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def _shfl(x, src):
    """__shfl_sync over the lane axis (axis 1 of (m, 32, ...)): lane l
    gets lane src[l]'s value."""
    return x[:, src]


def _lane_roll(s):
    """s[r][c] += old s[r][c - 1 mod 128], as the kernel does it."""
    u = _shfl(s, (LANES + 31) & 31)                  # (m, 32, 8, 4): u_j
    take = u.copy()
    take[:, 0] = u[:, 0][..., [3, 0, 1, 2]]          # lane 0: u_{(j+3)&3}
    return s + take


def _row_roll(s):
    """s[r] += old s[r - 1 mod 8]: register (r, j) adds (r - 1, j)."""
    return s + s[:, :, [7, 0, 1, 2, 3, 4, 5, 6]]


def _round(s):
    s = s * GOLD
    s = s ^ _rotr(s, 13)
    s = _lane_roll(s)
    s = s ^ _rotr(s, 7)
    return _row_roll(s)


def _stage(mem, start, length, b):
    """The 257 granules of block b of chunks at mem[start:start+length],
    as uint8 (m, 4112); returns them and each chunk's highest byte index
    read (-1 for none)."""
    base = start & ~15
    end = (start - base) + length                   # from base
    at = b * BLOCK + np.arange(GRANULES * 16)       # from base
    keep = at[None, :] < end[:, None]               # granule i < src-size
    idx = base[:, None] + at[None, :]
    got = np.where(keep, mem[np.where(keep, idx, 0)], 0).astype(np.uint8)
    hi = np.where(keep, idx, -1).max(axis=1)
    return got, hi


def _absorb(s, stage, a16):
    """Word k = 128 r + 32 j + l of the block: the two aligned stage words
    that hold it, funnel-shifted right by 8 (a16 & 3)."""
    w = stage.view("<u4").astype(np.uint64)         # (m, 1028)
    k = (128 * np.arange(8)[None, :, None] + 32 * np.arange(4)[None, None, :]
         + LANES[:, None, None])                   # (32, 8, 4)
    q = (a16 >> 2)[:, None, None, None]
    sh = (8 * (a16 & 3)).astype(np.uint64)[:, None, None, None]
    rows = np.arange(len(a16))[:, None, None, None]
    lo, hi = w[rows, q + k], w[rows, q + k + 1]
    return s ^ (((hi << np.uint64(32) | lo) >> sh) & np.uint64(0xFFFFFFFF)
                ).astype(np.uint32)


def warp_model(mem: np.ndarray, starts: np.ndarray, length: int):
    """Digests (m, 8) u32 of the chunks mem[start:start+length], all of one
    length, by the kernel's schedule; and each chunk's highest byte index
    read."""
    m = len(starts)
    lens = np.full(m, length, dtype=np.int64)
    a16 = (starts & 15).astype(np.int64)
    k = (128 * np.arange(8)[:, None] + 32 * np.arange(4)[None, :]
         )[None] + LANES[:, None, None]
    s = np.broadcast_to(_mix32(k.astype(np.uint32) + GOLD), (m, 32, 8, 4))
    nb = max(1, -(-length // BLOCK))
    top = np.full(m, -1)
    with np.errstate(over="ignore"):
        for b in range(nb):
            stage, hi = _stage(mem, starts, lens, b)
            top = np.maximum(top, hi)
            s = _absorb(s, stage, a16)
            for _ in range(4):
                s = _round(s)
        s = s ^ np.uint32(length & 0xFFFFFFFF)
        s = _round(_round(s))
        f = np.bitwise_xor.reduce(s, axis=-1)        # (m, 32, 8): f[r]
        for off in (16, 8, 4, 2, 1):
            f = f ^ _shfl(f, LANES ^ off)
        lane = np.arange(8)
        out = _mix32(f[:, lane, lane] ^ (lane.astype(np.uint32) * GOLD))
    return out, top


def _init_state():
    idx = np.arange(1024, dtype=np.uint32).reshape(8, 128)
    with np.errstate(over="ignore"):
        return _mix32(idx + GOLD)


def _to_registers(state):
    """(m, 8, 128) state -> (m, 32, 8, 4) registers, c = l + 32 j."""
    return state.reshape(-1, 8, 4, 32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("length", LENGTHS)
def test_warp_schedule_matches_references(length):
    """Chunks of one length at every offset 0..15 of a larger buffer of
    random bytes; the one at offset 15 ends at the buffer's last byte.
    Bytes past each other chunk are random, so a read past its end would
    change its digest."""
    rng = np.random.default_rng(length + 11)
    mem = rng.integers(0, 256, length + 15, dtype=np.uint8)
    starts = np.arange(16, dtype=np.int64)
    got, top = warp_model(mem, starts, length)
    assert (top < starts + length).all()        # nothing past a chunk's end
    blobs = [mem[o:o + length].tobytes() for o in starts]
    nbs = [max(1, -(-length // BLOCK))] * len(blobs)
    host = _fphash_many_host(blobs, nbs)
    plain = fphash_many_ref(torch.from_numpy(mem), torch.from_numpy(starts),
                            torch.full((16,), length, dtype=torch.int64))
    for i in range(16):
        assert got[i].astype("<u4").tobytes() == host[i]
        assert got[i].astype("<i4").tobytes() == \
            plain[i].numpy().astype("<i4").tobytes()


def test_register_rolls_are_np_roll():
    """The shuffle-and-select lane roll and the register row roll are
    np.roll of the (8, 128) state by one lane / one row."""
    rng = np.random.default_rng(4)
    state = rng.integers(0, 2**32, (3, 8, 128), dtype=np.uint64).astype(
        np.uint32)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(
            _lane_roll(_to_registers(state)),
            _to_registers(state + np.roll(state, 1, axis=-1)))
        np.testing.assert_array_equal(
            _row_roll(_to_registers(state)),
            _to_registers(state + np.roll(state, 1, axis=-2)))
    np.testing.assert_array_equal(
        _to_registers(_init_state()[None])[0, 5, 2, 1], _init_state()[2, 37])


def test_warp_fold_is_the_lane_xor():
    """Per-lane XOR of 4 registers, then 5 butterfly shuffles, leaves row
    r's XOR over its 128 lanes in every lane."""
    rng = np.random.default_rng(6)
    state = rng.integers(0, 2**32, (2, 8, 128), dtype=np.uint64).astype(
        np.uint32)
    f = np.bitwise_xor.reduce(_to_registers(state), axis=-1)
    for off in (16, 8, 4, 2, 1):
        f = f ^ _shfl(f, LANES ^ off)
    want = np.bitwise_xor.reduce(state, axis=-1)
    np.testing.assert_array_equal(f, np.broadcast_to(want[:, None], f.shape))
