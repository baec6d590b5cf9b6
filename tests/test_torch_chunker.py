"""Rolling hash + content-defined chunking invariants of the port
(repro_torch), and parity of its cuts with the JAX package, on the CPU.
Parity is exact: identical cut lists.  Seeded loops replace the
reference's hypothesis strategies."""
import numpy as np
import pytest
import torch

from repro.core import chunker as ref_chunker
from repro_torch.core import rolling
from repro_torch.core.chunker import (ChunkParams, boundary_bitmap, cut_bytes,
                                      cut_elements, index_cuts)
from repro_torch.kernels import ops

P8 = ChunkParams(q=8)
REF_P8 = ref_chunker.ChunkParams(q=8)


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def test_vectorized_matches_serial():
    data = np.random.default_rng(0).integers(0, 256, 3000, dtype=np.uint8)
    for w in (4, 16, 48):
        a = rolling.rolling_hash(torch.from_numpy(data), w).numpy()
        b = rolling.rolling_hash_serial(data.tobytes(), w)
        np.testing.assert_array_equal(a[w - 1:], b[w - 1:])


def test_expected_chunk_size():
    data = np.random.default_rng(0).integers(0, 256, 500_000, dtype=np.uint8)
    cuts = cut_bytes(data, P8)
    mean = len(data) / len(cuts)
    assert 150 < mean < 420, mean     # E[chunk] = 2^8 = 256


def test_boundaries_are_content_local():
    """Edit at position p only moves boundaries in [p, p+window+max)."""
    data = np.random.default_rng(0).integers(0, 256, 100_000, dtype=np.uint8)
    b1 = boundary_bitmap(data, P8).numpy()
    data2 = data.copy()
    data2[50_000] ^= 0xFF
    b2 = boundary_bitmap(data2, P8).numpy()
    np.testing.assert_array_equal(b1[:50_000], b2[:50_000])
    np.testing.assert_array_equal(b1[50_000 + P8.window:],
                                  b2[50_000 + P8.window:])


def test_cut_bytes_partition():
    rng = np.random.default_rng(1)
    for _ in range(30):
        arr = rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8)
        cuts = cut_bytes(arr, P8)
        if len(arr) == 0:
            assert cuts == []
            continue
        assert cuts[-1] == len(arr)
        assert all(0 < a < b for a, b in zip(cuts, cuts[1:]))
        assert max(np.diff([0] + cuts)) <= P8.max_size


def test_cut_elements_alignment():
    rng = np.random.default_rng(2)
    for _ in range(30):
        elements = [rng.bytes(int(rng.integers(1, 301)))
                    for _ in range(int(rng.integers(1, 61)))]
        stream = np.frombuffer(b"".join(elements), dtype=np.uint8)
        bitmap = boundary_bitmap(stream, P8)
        cuts = cut_elements([len(e) for e in elements], bitmap, P8)
        assert cuts[-1] == len(elements)
        assert all(a < b for a, b in zip(cuts, cuts[1:]))
        # forced split cannot break a single element
        assert all(s >= 1 for s in np.diff([0] + cuts))


def test_index_cuts_fanout():
    rng = np.random.default_rng(0)
    cids = [rng.bytes(32) for _ in range(5000)]
    cuts = index_cuts(cids, P8)
    assert cuts[-1] == len(cids)
    fan = np.diff([0] + cuts)
    assert fan.max() <= P8.index_max_fanout
    assert 20 < fan.mean() < 200      # E[fanout] = 2^6 = 64


@pytest.mark.parametrize("q", [4, 8, 12])
def test_cut_bytes_parity(q):
    rng = np.random.default_rng(q)
    params, ref_params = ChunkParams(q=q), ref_chunker.ChunkParams(q=q)
    for n in (0, 1, 47, 4096, 65_537, 300_000):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert cut_bytes(data, params) == ref_chunker.cut_bytes(data,
                                                                ref_params)


def test_cut_elements_parity():
    rng = np.random.default_rng(4)
    for _ in range(20):
        elements = [rng.bytes(int(rng.integers(1, 2000)))
                    for _ in range(int(rng.integers(1, 400)))]
        lengths = [len(e) for e in elements]
        stream = np.frombuffer(b"".join(elements), dtype=np.uint8)
        got = cut_elements(lengths, boundary_bitmap(stream, P8), P8)
        want = ref_chunker.cut_elements(
            lengths, ref_chunker.boundary_bitmap(stream, REF_P8), REF_P8)
        assert got == want


def test_index_cuts_parity():
    rng = np.random.default_rng(6)
    for n in (0, 1, 63, 64, 5000):
        cids = [rng.bytes(32) for _ in range(n)]
        assert index_cuts(cids, P8) == ref_chunker.index_cuts(cids, REF_P8)
