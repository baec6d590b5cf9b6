"""Plain PyTorch versions of the CUDA kernels, on any device.

  * boundary_bitmap_ref — the rolling-hash boundary bitmap, which is
    ``core.rolling.boundary_bitmap`` (the storage engine's plain path);
  * fphash_ref / fphash_many_ref — the 256-bit sponge content hash of one
    byte string / of a ragged batch.

u32 arithmetic is done in int64 and masked to 32 bits.  Digests come back
as int32 tensors holding the u32 bits, like the kernels' outputs.
"""
from __future__ import annotations

import torch

from ..core import rolling
from ..core.rolling import GOLD, MASK32, mix32, mul32

# ------------------------------------------------------------- chunker ref


def boundary_bitmap_ref(data: torch.Tensor, window: int, q: int) -> torch.Tensor:
    return rolling.boundary_bitmap(data, window, q)


# ------------------------------------------------------------- fphash ref

FP_ROUNDS = 4
FP_BLOCK_WORDS = 1024            # 4 KB per absorb block
FP_BLOCK_BYTES = 4 * FP_BLOCK_WORDS
FP_STATE = (8, 128)              # u32 sponge state
# rows of one plain-version sweep: bounds its memory on long batches
_SWEEP_BYTES = 1 << 27


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & MASK32


def fp_init_state(device=None) -> torch.Tensor:
    idx = torch.arange(FP_STATE[0] * FP_STATE[1], dtype=torch.int64,
                       device=device).reshape(FP_STATE)
    return mix32(idx + GOLD)


def fp_round(state: torch.Tensor) -> torch.Tensor:
    """One diffusion round over (..., 8, 128) states: multiply,
    xor-rotate, lane roll-add, xor-rotate, sublane roll-add."""
    state = mul32(state, GOLD)
    state = state ^ _rotr(state, 13)
    state = (state + torch.roll(state, 1, dims=-1)) & MASK32
    state = state ^ _rotr(state, 7)
    return (state + torch.roll(state, 1, dims=-2)) & MASK32


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _words(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
           nb: int) -> torch.Tensor:
    """(m, nb, 1024) little-endian u32 words of m chunks, zero-padded to nb
    blocks."""
    pos = torch.arange(nb * FP_BLOCK_BYTES, device=data.device)
    valid = pos[None, :] < lengths[:, None]
    if data.numel() == 0:
        b = torch.zeros(valid.shape, dtype=torch.int64, device=data.device)
    else:
        idx = (offsets[:, None] + pos[None, :]).clamp_(max=data.numel() - 1)
        b = torch.where(valid, data[idx].long(), 0)
    b = b.view(-1, nb, FP_BLOCK_WORDS, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _sponge(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    m, nb = words.shape[:2]
    state = fp_init_state(words.device).expand((m,) + FP_STATE)
    for blk in range(nb):
        state = state ^ words[:, blk].view((m,) + FP_STATE)
        for _ in range(FP_ROUNDS):
            state = fp_round(state)
    state = state ^ (lengths & MASK32)[:, None, None]
    state = fp_round(fp_round(state))
    folded = state
    while folded.shape[-1] > 1:          # xor-reduce the 128 lanes
        half = folded.shape[-1] // 2
        folded = folded[..., :half] ^ folded[..., half:]
    lane = torch.arange(FP_STATE[0], dtype=torch.int64, device=words.device)
    return mix32(folded[..., 0] ^ mul32(lane, GOLD))


def fphash_many_ref(data: torch.Tensor, offsets: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Digests of a ragged batch: chunk i is ``lengths[i]`` bytes at
    ``offsets[i]`` of ``data``.  Chunks are swept together by block count
    (at least one block, so the empty string hashes one zero block).
    Returns int32 (n, 8)."""
    n = lengths.numel()
    out = torch.empty((n, 8), dtype=torch.int64, device=data.device)
    nbs = ((lengths + FP_BLOCK_BYTES - 1) // FP_BLOCK_BYTES).clamp_(min=1)
    for nb in torch.unique(nbs).tolist():
        rows = torch.nonzero(nbs == nb).flatten()
        step = max(1, _SWEEP_BYTES // (nb * FP_BLOCK_BYTES))
        for s in range(0, rows.numel(), step):
            sub = rows[s:s + step]
            words = _words(data, offsets[sub], lengths[sub], nb)
            out[sub] = _sponge(words, lengths[sub])
    return _as_int32(out)


def fphash_ref(data: torch.Tensor) -> torch.Tensor:
    """Digest of one byte string, int32 (8,)."""
    zero = torch.zeros(1, dtype=torch.int64, device=data.device)
    n = torch.full((1,), data.numel(), dtype=torch.int64, device=data.device)
    return fphash_many_ref(data, zero, n)[0]
