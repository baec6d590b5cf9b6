"""The host glue of the engine's single-value fphash route
(``kernels.fphash.fphash_host``, and ``ops.content_hash`` on a CUDA engine
device), on the CPU: torch's pinned allocator and the CUDA library are
stubbed by monkeypatch.  The stub library maps a buffer to its own address
(as unified addressing does), reads the staged bytes at the pointer it is
given and writes the plain version's digest to the out pointer, as the
kernel does on the card (where chip_smoke.py holds the kernel itself to
the plain version).

Tolerance: none, every digest is compared bit for bit with the JAX
package's.
"""
import ctypes
import sys
import threading

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

from repro.kernels.fphash import _fphash_many_host
from repro.kernels.fphash import fphash as ref_fphash
from repro_torch.core import chunk, hashing
from repro_torch.errors import ConfigError, KernelError
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import fphash as kfphash
from repro_torch.kernels.counter import LAUNCHES

FP_LENGTHS = [0, 1, 31, 4095, 4096, 4097, 12288, 32768, 32769, 65536]
HOST_LENGTHS = FP_LENGTHS + [63, 4097, 32_769, 36_865, (1 << 20) + 3]
PLAIN = ref.fphash_ref          # kept: a test replaces ref's name
CUDA0 = torch.device("cuda", 0)


def _want(data: bytes) -> bytes:
    """The JAX package's digest: its Pallas entry point (interpret mode on
    the CPU) up to 32,769 B, its numpy batch path beyond."""
    if len(data) <= 32_769:
        return ref_fphash(data)
    return _fphash_many_host([data], [-(-len(data) // 4096)])[0]


class FakeLib:
    """The library's two entries of the single-value route, on host memory
    (``err`` / ``map_err``: the CUDA error each returns)."""

    def __init__(self, err: int = 0, map_err: int = 0):
        self.err, self.map_err = err, map_err
        self.maps: list[tuple[int, int]] = []
        self.launches: list[tuple[int, int, int, int, int]] = []
        self._lock = threading.Lock()

    def fphash_host_map(self, host, device, view):
        with self._lock:
            self.maps.append((host, device))
        view._obj.value = host          # the argument of ctypes.byref
        return self.map_err

    def fphash_host_cuda(self, src, n, out, device, stream):
        with self._lock:
            self.launches.append((src, n, out, device, stream))
        if self.err:
            return self.err
        data = bytearray(ctypes.string_at(src, n))
        digest = PLAIN(torch.frombuffer(data, dtype=torch.uint8)
                       if n else torch.zeros(0, dtype=torch.uint8))
        ctypes.memmove(out, digest.numpy().astype("<i4").tobytes(), 32)
        return 0


@pytest.fixture
def lib(monkeypatch):
    """Stubbed pinned allocator (``lib.pins``: every buffer it gave), CUDA
    library and stream handle; fresh per-thread staging; zeroed launch
    counts."""
    fake = FakeLib()
    fake.pins = []

    def pin(nbytes):
        buf = torch.empty(nbytes, dtype=torch.uint8)
        fake.pins.append(buf)
        return buf

    monkeypatch.setattr(kfphash, "_pin", pin)
    monkeypatch.setattr(build, "lib", lambda name: fake)
    monkeypatch.setattr(kfphash, "_local", threading.local())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    LAUNCHES.reset()
    yield fake
    LAUNCHES.reset()


@pytest.mark.parametrize("n", HOST_LENGTHS)
def test_digests_match_the_reference(lib, n):
    data = np.random.default_rng(n + 3).bytes(n)
    want = _want(data)
    assert kfphash.fphash_host(data, CUDA0) == want
    assert kfphash.fphash_host(bytearray(data), CUDA0) == want
    wide = b"\x05" * 3 + data + b"\x05" * 5
    assert kfphash.fphash_host(memoryview(wide)[3:3 + n], CUDA0) == want
    src, length, out, device, stream = lib.launches[-1]
    assert (length, device, stream) == (n, 0, 7)


def test_staging_grows_by_doubling_and_is_reused(lib):
    rng = np.random.default_rng(1)
    small, big = rng.bytes(100), rng.bytes((1 << 20) + 3)
    assert kfphash.fphash_host(small, CUDA0) == _want(small)
    # the 32-byte digest buffer, then the first input buffer
    assert [p.numel() for p in lib.pins] == [32, kfphash.STAGING_BYTES]
    assert [h for h, _ in lib.maps] == [p.data_ptr() for p in lib.pins]
    assert kfphash.fphash_host(big, CUDA0) == _want(big)
    assert lib.pins[-1].numel() == 2 << 20       # 64 KiB doubled 5 times
    assert kfphash.fphash_host(small[:10], CUDA0) == _want(small[:10])
    assert kfphash.fphash_host(big[:70_000], CUDA0) == _want(big[:70_000])
    assert len(lib.pins) == 3 and len(lib.maps) == 3
    out = lib.pins[0].data_ptr()
    assert [(s, o) for s, _, o, _, _ in lib.launches] == \
        [(lib.pins[1].data_ptr(), out)] + \
        [(lib.pins[2].data_ptr(), out)] * 3


def test_eight_threads_get_their_own_digests(lib):
    """8 threads x 200 distinct values at once: each thread stages in its
    own pinned buffers, so every digest is its own value's."""
    threads, each = 8, 200
    values = [[np.random.default_rng(100 + i).bytes(int(n)) for n in
               np.random.default_rng(i).integers(0, 300, each)]
              for i in range(threads)]
    got: list[list[bytes]] = [[] for _ in range(threads)]
    start, done = threading.Barrier(threads), threading.Barrier(threads)
    errors: list[BaseException] = []

    def work(i):
        try:
            start.wait(timeout=60)
            for v in values[i]:
                got[i].append(kfphash.fphash_host(v, CUDA0))
            done.wait(timeout=60)       # every staging alive to the end
        except Exception as e:           # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        workers = [threading.Thread(target=work, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    for i in range(threads):
        nbs = [max(1, -(-len(v) // 4096)) for v in values[i]]
        assert got[i] == _fphash_many_host(values[i], nbs)
    assert len(lib.pins) == 2 * threads
    assert len({s for s, *_ in lib.launches}) == threads
    assert LAUNCHES.snapshot()["fphash"] == threads * each


def test_one_fphash_launch_counted_a_call(lib):
    for i in range(5):
        kfphash.fphash_host(b"x" * i, CUDA0)
    assert LAUNCHES.snapshot() == {"boundary_bitmap": 0, "fphash_many": 0,
                                   "fphash": 5}
    assert len(lib.launches) == 5


def test_a_failed_launch_or_mapping_raises(lib):
    lib.err = 700
    with pytest.raises(KernelError, match="fphash_host_cuda"):
        kfphash.fphash_host(b"abc", CUDA0)
    assert LAUNCHES.snapshot()["fphash"] == 0
    lib.err = 0
    lib.map_err = 801                    # the mapping of a new buffer
    with pytest.raises(KernelError, match="fphash_host_map"):
        kfphash.fphash_host(b"y" * (1 << 17), CUDA0)
    assert LAUNCHES.snapshot()["fphash"] == 0


def test_content_hash_on_cuda_reaches_only_fphash_host(lib, monkeypatch):
    """On a CUDA engine device the single hash is one fphash_host launch
    on the engine's device: no tensor route, no plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("the single-value route left fphash_host")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("fphash", "fphash_many"):
        monkeypatch.setattr(kfphash, name, refuse)
    for mod in (ops, ref):
        monkeypatch.setattr(mod, "fphash_ref", refuse)
    monkeypatch.setattr(ops, "to_device", refuse)
    data = np.random.default_rng(4).bytes(4097)
    ops.set_device("cuda:1")
    try:
        assert ops.content_hash(data) == _want(data)
        hashing.use_fphash()
        assert chunk.cid_of(data) == _want(data)
    finally:
        hashing.use_sha256()
        ops.set_device("cuda")
    assert [(n, d) for _, n, _, d, _ in lib.launches] == [(4097, 1)] * 2
    assert {d for _, d in lib.maps} == {1}
    assert LAUNCHES.snapshot()["fphash"] == 2


def test_cuda_engine_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's")
    ops.set_device("cuda")
    with pytest.raises(ConfigError):
        ops.content_hash(b"abc")
