"""Golden values: fixed outputs of the reference (the JAX package) for a
few seeded inputs.  The CPU tests assert that the reference still produces
them and that the port matches; ``chip_smoke.py`` holds the CUDA kernels to
the same constants on a machine without JAX.

Inputs are made with ``numpy.random.default_rng``, so they are the same on
every machine.
"""
from __future__ import annotations

import hashlib

import numpy as np

SEED = 11

# fphash digests of default_rng(SEED).bytes(n) for n in FPHASH_LENGTHS,
# drawn in that order from one generator
FPHASH_LENGTHS = (0, 1, 31, 4095, 4096, 4097, 12288, 32769)
FPHASH = (
    "b2dd74c6f1ccc7744c69519dcbbd3c8f497baaeb51463f11ada040b4b3d9fa8d",
    "e54eeeb927fbc0c9b12e7fe346b432ec42b3a5e2218bff6334a9a627321ee2c8",
    "53e1dceb682a7d7d2d4ea38c2a5ed0a6e9b79f7974c6a17639fa811fbc447267",
    "c7d584d73a3af7f196ac5c9d10a0f5c611c0f249cb694475ec45402ad2039d17",
    "ca95535f5aaae80cf9088e4176cd36e6e5e73f50d8880c9f3ddf9f3bad69b2bd",
    "4e4ad7769952b41b186b5abe1dabe13780b528766f29cadaa1af4ee0f49f124d",
    "c66406783325b74094515b27d55b05be3805e6004fb8e23029c614d54c467160",
    "6758450bde307f134a2d06c9bfdbffbceb98dd38967fcc7b640459231f9a0a67",
)

# the blob: default_rng(SEED + 1).bytes(BLOB_LEN)
BLOB_LEN = 300_000
# (window, q) -> (hit count, sha256 of the hit positions as little-endian
# int64) of the boundary bitmap over the blob
BITMAP = {
    (48, 12): (73, "d94744143a24193523e745bec152d8de"
                   "aa70a84dcd70adbc80fc8e664112310f"),
    (16, 8): (1125, "80c02fc316f6b9e93aa673329b071b47"
                    "46eb9aea94ffad814d44d65a6e23ac62"),
    (128, 10): (276, "d93fce550d87da76bcd6c9d8da94cc0c"
                     "1f8add7712dbdbd757790913ae0638ba"),
    (4, 4): (18743, "5bd19ff2f5f10321a003db6e228e0eeb"
                    "395d70d0cd0ce132fed83ebbbe486955"),
}
# POSTree.build_bytes(store, blob) root cid with the default ChunkParams
ROOT_SHA256 = "f97a827f50f8ce40e077fa019c31ab560c8d6e5e534880b93f9465a2e6201bf6"
ROOT_FPHASH = "999fe89dbd9e7d9c44ee528a4d3cab778b5b75c13933068a7afffc5968243fad"


def fphash_inputs() -> list[bytes]:
    rng = np.random.default_rng(SEED)
    return [rng.bytes(n) for n in FPHASH_LENGTHS]


def blob() -> bytes:
    return np.random.default_rng(SEED + 1).bytes(BLOB_LEN)


def bitmap_digest(hit_positions: np.ndarray) -> tuple[int, str]:
    """(count, sha256 hex) of a bitmap's hit positions, as in BITMAP."""
    pos = np.asarray(hit_positions, dtype="<i8")
    return len(pos), hashlib.sha256(pos.tobytes()).hexdigest()
