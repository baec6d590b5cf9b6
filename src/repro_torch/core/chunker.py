"""Content-defined chunking with element alignment (paper §2.1, §4.3).

Splits a byte stream (Blob) or a stream of serialized elements (List / Map /
Set) into chunks at *pattern* positions from the rolling hash.  Two paper
rules on top of the raw bitmap:

  * element alignment — "if a pattern occurs in the middle of an element the
    chunk boundary is extended to cover the whole element, so that no
    elements are stored in more than one chunk" (§4.3.2);
  * forced split — "the chunk size cannot be alpha times bigger than the
    average size; otherwise it is forcefully chunked" (§4.3.3).

Cut positions are derived from the *global* boundary bitmap (the rolling
window never resets at cuts), so cuts strictly before an edit are unaffected
by it, and cuts re-align k bytes after the edit — the property incremental
commits rely on (postree.py) and tests/test_chunker.py asserts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops as _ops


@dataclass(frozen=True)
class ChunkParams:
    """Knobs from §4.3.3.  Defaults reproduce the paper's 4 KB chunks."""

    window: int = 48          # rolling-hash window k (bytes)
    q: int = 12               # leaf pattern bits -> E[chunk] = 2^q = 4 KB
    max_factor: int = 8       # alpha: forced split at alpha * 2^q bytes
    index_r: int = 6          # index-node pattern bits -> E[fanout] = 2^r
    index_max_factor: int = 8  # forced split for index fanout

    @property
    def avg_size(self) -> int:
        return 1 << self.q

    @property
    def max_size(self) -> int:
        return self.max_factor * self.avg_size

    @property
    def index_fanout(self) -> int:
        return 1 << self.index_r

    @property
    def index_max_fanout(self) -> int:
        return self.index_max_factor * self.index_fanout


DEFAULT_PARAMS = ChunkParams()


def _device_bitmap(data, window: int, q: int) -> torch.Tensor:
    # bound at call time: kernels.ops imports this package back
    return _ops.boundary_bitmap(data, window, q)


# Kernel hook: the default is the device wrapper, which launches the CUDA
# boundary kernel on ops.device() (its plain PyTorch version when that
# device is the CPU).  kernels.ops.use_kernel_chunker(False) selects the
# plain version on the device; both give the same bits.
_bitmap_impl = _device_bitmap


def set_bitmap_impl(fn) -> None:
    global _bitmap_impl
    _bitmap_impl = fn


def boundary_bitmap(data: np.ndarray, params: ChunkParams = DEFAULT_PARAMS) -> torch.Tensor:
    """bool[n] boundary bitmap of a host byte stream, as a tensor on the
    engine's device."""
    return _bitmap_impl(data, params.window, params.q)


def _hits(bitmap: torch.Tensor) -> np.ndarray:
    """Host positions just after each pattern byte.  Only the hit indices
    cross to the host, never the n-byte bitmap."""
    return torch.nonzero(bitmap).flatten().cpu().numpy() + 1


def cut_bytes(data: np.ndarray, params: ChunkParams = DEFAULT_PARAMS,
              bitmap: torch.Tensor | None = None) -> list[int]:
    """Exclusive cut offsets for a raw byte stream (Blob).

    Returns offsets c_1 < c_2 < ... <= n such that chunks are
    [0,c_1), [c_1,c_2), ...; the final offset n is always included.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = int(data.shape[0])
    if n == 0:
        return []
    if bitmap is None:
        bitmap = boundary_bitmap(data, params)
    hits = _hits(bitmap)  # cut AFTER the pattern byte
    return _apply_max_size(hits.tolist(), n, params.max_size)


def _apply_max_size(hits: list[int], end: int, max_size: int) -> list[int]:
    cuts: list[int] = []
    start = 0
    i = 0
    m = len(hits)
    while start < end:
        # next pattern cut after start
        while i < m and hits[i] <= start:
            i += 1
        nxt = hits[i] if i < m else end
        if nxt - start > max_size:
            nxt = start + max_size  # forced split (§4.3.3)
        elif nxt > end:
            nxt = end
        cuts.append(nxt)
        start = nxt
    if not cuts or cuts[-1] != end:
        cuts.append(end)
    return cuts


def cut_elements(lengths: Sequence[int], bitmap: torch.Tensor,
                 params: ChunkParams = DEFAULT_PARAMS) -> list[int]:
    """Element-aligned cuts.

    lengths: per-element serialized byte lengths; bitmap: boundary bitmap of
    the concatenated element stream.  Returns exclusive cut indices in
    *element* space (last == len(lengths)).  A pattern inside element e cuts
    after e; forced split caps chunk bytes at max_size but never splits a
    single oversized element.
    """
    n_el = len(lengths)
    if n_el == 0:
        return []
    ends = np.cumsum(np.asarray(lengths, dtype=np.int64))  # byte end of each element
    total = int(ends[-1])
    hits = _hits(bitmap)  # byte positions after patterns
    # element whose byte-range contains each pattern -> cut after that element
    el_of_hit = np.searchsorted(ends, hits, side="left")
    cut_after = np.unique(el_of_hit[el_of_hit < n_el]) + 1  # element-space cuts
    cuts: list[int] = []
    start_el = 0
    start_byte = 0
    i = 0
    m = len(cut_after)
    max_size = params.max_size
    while start_el < n_el:
        while i < m and cut_after[i] <= start_el:
            i += 1
        nxt = int(cut_after[i]) if i < m else n_el
        # forced split in byte space, snapped to element ends
        if int(ends[nxt - 1]) - start_byte > max_size:
            j = int(np.searchsorted(ends, start_byte + max_size, side="right"))
            j = max(j, start_el + 1)  # never split below one element
            nxt = min(j, nxt)
        cuts.append(nxt)
        start_el = nxt
        start_byte = int(ends[nxt - 1])
    if not cuts or cuts[-1] != n_el:
        cuts.append(n_el)
    return cuts


def index_cuts(cids: Sequence[bytes], params: ChunkParams = DEFAULT_PARAMS) -> list[int]:
    """Index-node splitting (§4.3.3): pattern iff cid & (2^r - 1) == 0.

    P' reads the already-random child cid instead of re-hashing, matching the
    paper's optimization (rolling hash = 20% of build cost).  Returns
    exclusive cut indices in entry space.
    """
    n = len(cids)
    if n == 0:
        return []
    mask = (1 << params.index_r) - 1
    cuts: list[int] = []
    start = 0
    count = 0
    for i, cid in enumerate(cids):
        count += 1
        if (cid[0] & mask) == 0 or count >= params.index_max_fanout:
            cuts.append(i + 1)
            start = i + 1
            count = 0
    if not cuts or cuts[-1] != n:
        cuts.append(n)
    return cuts
