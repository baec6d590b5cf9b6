"""Port kernels (repro_torch) against the JAX package, on the CPU.

The port's wrappers get CPU tensors here, so they run their plain PyTorch
versions; the CUDA kernels are held to those on the card by chip_smoke.py.
Every comparison is exact: bitmaps and digests must be identical bit for
bit (tolerance zero).  Inputs come from numpy seeds.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro.core import rolling as ref_rolling
from repro.kernels.chunker import boundary_bitmap_pallas
from repro.kernels.fphash import fphash as ref_fphash
from repro.kernels.fphash import fphash_many as ref_fphash_many
from repro.kernels.ref import fphash_ref as ref_fphash_ref
from repro_torch.core import rolling
from repro_torch.errors import ConfigError
from repro_torch.kernels import golden, ops
from repro_torch.kernels.chunker import boundary_bitmap
from repro_torch.kernels.fphash import fphash, fphash_many
from repro_torch.kernels.ref import fphash_many_ref, fphash_ref

N_GRID = [1, 47, 48, 255, 4991, 4992, 4993, 39936, 100_001]
WQ_GRID = [(48, 12), (16, 8), (128, 10), (4, 4)]
FP_LENGTHS = [0, 1, 31, 4095, 4096, 4097, 12288, 32768, 32769, 65536]


@pytest.fixture(autouse=True)
def _cpu_device():
    ops.set_device("cpu")
    yield
    ops.set_device("cuda")


def _digest_hex(d: torch.Tensor) -> str:
    return d.numpy().astype("<i4").tobytes().hex()


@pytest.mark.parametrize("n", N_GRID)
@pytest.mark.parametrize("wq", WQ_GRID)
def test_chunker_matches_reference(n, wq):
    w, q = wq
    data = np.random.default_rng(n * 1000 + w).integers(0, 256, n,
                                                        dtype=np.uint8)
    got = boundary_bitmap(torch.from_numpy(data), w, q).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, boundary_bitmap_pallas(data, w, q))
    np.testing.assert_array_equal(got, ref_rolling.boundary_bitmap(data, w, q))


def test_chunker_seeded_small_streams():
    """The seeded-loop stand-in for the reference's hypothesis sweep."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        data = rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8)
        w = int(rng.choice([8, 16, 48]))
        got = boundary_bitmap(torch.from_numpy(data), w, 6).numpy()
        np.testing.assert_array_equal(got,
                                      ref_rolling.boundary_bitmap(data, w, 6))


def test_chunker_segments_join_seamlessly(monkeypatch):
    """The plain version sweeps long streams in segments with a window
    halo; shrunk segments must give the one-pass bits."""
    data = np.random.default_rng(3).integers(0, 256, 20_000, dtype=np.uint8)
    want = ref_rolling.boundary_bitmap(data, 48, 6)
    monkeypatch.setattr(rolling, "_SEGMENT", 1000)
    got = rolling.boundary_bitmap(torch.from_numpy(data), 48, 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_chunker_rejects_what_the_kernel_cannot_take():
    data = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ConfigError):
        boundary_bitmap(data, 129, 12)          # beyond the kernel's halo
    with pytest.raises(ConfigError):
        boundary_bitmap(data, 0, 12)
    with pytest.raises(ConfigError):
        boundary_bitmap(data.long(), 48, 12)


def test_rolling_hash_matches_reference_and_serial():
    data = np.random.default_rng(5).integers(0, 256, 3000, dtype=np.uint8)
    for w in (4, 16, 48, 128):
        got = rolling.rolling_hash(torch.from_numpy(data), w).numpy()
        np.testing.assert_array_equal(got, ref_rolling.rolling_hash(data, w))
        serial = rolling.rolling_hash_serial(data.tobytes(), w)
        np.testing.assert_array_equal(got[w - 1:], serial[w - 1:])


@pytest.mark.parametrize("n", FP_LENGTHS)
def test_fphash_matches_reference(n):
    data = np.random.default_rng(n + 1).bytes(n)
    got = fphash(torch.frombuffer(bytearray(data), dtype=torch.uint8)
                 if n else torch.zeros(0, dtype=torch.uint8))
    want = ref_fphash(data)
    assert want == ref_fphash_ref(data)
    assert got.dtype == torch.int32 and got.shape == (8,)
    assert got.numpy().astype("<i4").tobytes() == want
    assert ops.content_hash(data) == want


def test_fphash_many_ragged_batch_matches_reference():
    rng = np.random.default_rng(9)
    lengths = FP_LENGTHS + [int(x) for x in rng.integers(0, 70_000, 14)]
    rng.shuffle(lengths)
    blobs = [rng.bytes(n) for n in lengths]
    want = ref_fphash_many(blobs)                 # numpy host path off TPU
    assert want == [ref_fphash_ref(b) for b in blobs]
    assert ops.content_hash_many(blobs) == want
    data, offs, lens = (ops.to_device(b"".join(blobs)),
                        torch.tensor(np.cumsum([0] + lengths[:-1])),
                        torch.tensor(lengths))
    assert torch.equal(fphash_many(data, offs, lens),
                       fphash_many_ref(data, offs, lens))
    assert ops.content_hash_many([]) == []


def test_fphash_many_reads_only_its_ranges():
    """Chunks at arbitrary offsets of a larger buffer, out of order and
    overlapping: each digest is that of its own byte range."""
    buf = np.random.default_rng(2).bytes(20_000)
    ranges = [(17, 4100), (0, 0), (5000, 1), (3, 9000), (19_999, 1)]
    digests = fphash_many(torch.frombuffer(bytearray(buf), dtype=torch.uint8),
                          torch.tensor([o for o, _ in ranges]),
                          torch.tensor([n for _, n in ranges]))
    for (o, n), d in zip(ranges, digests):
        assert d.numpy().astype("<i4").tobytes() == ref_fphash(buf[o:o + n])
    with pytest.raises(ConfigError):
        fphash_many(torch.zeros(10, dtype=torch.uint8), torch.tensor([5]),
                    torch.tensor([6]))


def test_fphash_avalanche():
    d = bytearray(np.random.default_rng(0).bytes(5000))
    h0 = ops.content_hash(bytes(d))
    d[2500] ^= 1
    h1 = ops.content_hash(bytes(d))
    assert h0 != h1
    diff = bin(int.from_bytes(h0, "little")
               ^ int.from_bytes(h1, "little")).count("1")
    assert 64 < diff < 192       # ~half the 256 bits flip


def test_golden_values_of_reference_and_port():
    """The reference still produces the golden constants chip_smoke.py
    holds the CUDA kernels to, and so does the port."""
    inputs = golden.fphash_inputs()
    assert [ref_fphash(b).hex() for b in inputs] == list(golden.FPHASH)
    assert [d.hex() for d in ops.content_hash_many(inputs)] == \
        list(golden.FPHASH)
    blob = np.frombuffer(golden.blob(), dtype=np.uint8)
    for (w, q), want in golden.BITMAP.items():
        ref_hits = np.flatnonzero(ref_rolling.boundary_bitmap(blob, w, q))
        assert golden.bitmap_digest(ref_hits) == want
        hits = torch.nonzero(boundary_bitmap(torch.from_numpy(blob.copy()),
                                             w, q)).flatten().numpy()
        assert golden.bitmap_digest(hits) == want


def test_use_kernel_hash_switches_the_batched_hash():
    """use_kernel_hash routes content_hash_many through fphash_many and
    back to sha256, as the reference's use_pallas_hash does.  On the CPU
    the wrapper runs its plain version and counts no launch."""
    from repro_torch.core import hashing
    blobs = [b"", b"abc", np.random.default_rng(8).bytes(5000)]
    try:
        ops.use_kernel_hash()
        assert hashing.content_hash_many(blobs) == ref_fphash_many(blobs)
        assert hashing.content_hash(blobs[1]) == ref_fphash(blobs[1])
        ops.use_kernel_hash(False)
        assert hashing.content_hash_many(blobs) == \
            [hashlib.sha256(b).digest() for b in blobs]
    finally:
        hashing.use_sha256()
    assert set(ops.__all__) <= set(dir(ops))


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    ops.set_device("cuda")
    with pytest.raises(ConfigError):
        ops.content_hash(b"abc")
    with pytest.raises(ConfigError):
        ops.boundary_bitmap(np.zeros(100, dtype=np.uint8))
