"""Content hashing for cids/uids (paper §4.2.1).

The paper uses SHA-256 by default and explicitly allows faster alternatives
("e.g., BLAKE2"). We keep SHA-256 as the host default for externally
verifiable tamper evidence, and expose a pluggable interface so the dedup
path can use the ``fphash`` CUDA kernels on the engine's device (see
kernels/fphash.py).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Sequence

# A cid is the raw 32-byte digest of chunk bytes.  We keep bytes (not hex)
# internally; hex only at display boundaries.
CID_LEN = 32

HashFn = Callable[[bytes], bytes]
BatchHashFn = Callable[[Sequence[bytes]], "list[bytes]"]


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha256_many(blobs: Sequence[bytes]) -> list[bytes]:
    return [hashlib.sha256(b).digest() for b in blobs]


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


_DEFAULT: HashFn = sha256
_DEFAULT_MANY: BatchHashFn = sha256_many


def set_default_hash(fn: HashFn, many: BatchHashFn | None = None) -> None:
    """Swap the cid hash.  ``many`` is the vectorized entry point used by
    the batched store pipeline; without one, the singular fn is mapped."""
    global _DEFAULT, _DEFAULT_MANY
    _DEFAULT = fn
    _DEFAULT_MANY = many if many is not None else (
        lambda blobs: [fn(b) for b in blobs])


def use_fphash() -> None:
    """Route cid computation through the ``fphash`` kernels on the
    engine's device (kernels.ops): the batched entry point hashes every
    chunk of a batch in ONE kernel launch.  sha256 stays the verifiable
    default."""
    from ..kernels import ops
    set_default_hash(ops.content_hash, ops.content_hash_many)


def use_sha256() -> None:
    set_default_hash(sha256, sha256_many)


def current_hash() -> HashFn:
    """Identity of the active cid hash — callers that memoize digests
    (delta attestations, verify memos) compare this across calls and
    rebuild wholesale when the algorithm was swapped."""
    return _DEFAULT


def content_hash(data: bytes) -> bytes:
    """chunk.cid = H(chunk.bytes)  (paper §4.2.1)."""
    return _DEFAULT(data)


def content_hash_many(blobs: Sequence[bytes]) -> list[bytes]:
    """Vectorized cid computation for a batch of chunks — one dispatch for
    the whole batch (one kernel launch per batch on the fphash path)."""
    return _DEFAULT_MANY(list(blobs))


def hex(cid: bytes) -> str:
    return cid.hex()[:16]  # short display form
