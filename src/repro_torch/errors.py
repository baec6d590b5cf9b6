"""Unified exception hierarchy — every runtime invariant the engine can
violate raises a :class:`ReproError` subclass defined HERE.

One module, zero imports, so every layer (storage backends, the obs
layer, the analysis engine itself) can depend on it without cycles.
Each class keeps its historical builtin base (``KeyError``,
``ValueError``, ``RuntimeError``, ``AssertionError``) so call sites
that caught builtins keep working; the original defining modules
(``storage.backend``, ``core.branch``, ``proof.membership``,
``core.runtime``, ``core.cluster``, ``core.merge``) re-export their
classes from here for compatibility.

This hierarchy is the target of the CONTRACT001 static-analysis rule
(the repository's ``analysis`` gate): bare ``raise Exception``/``RuntimeError`` and
``assert`` statements for runtime invariants in engine code are flagged
— an invariant that can fire in production must be typed so callers can
catch it, and must survive ``python -O``.
"""
from __future__ import annotations

__all__ = [
    "ReproError",
    "ConfigError",
    "InvariantViolation",
    "ChunkMissing",
    "TamperedChunk",
    "RoutingIndexMiss",
    "BranchExists",
    "NoSuchRef",
    "GuardFailed",
    "MergeConflict",
    "InvalidProof",
    "Backpressure",
    "CollectionInFlight",
    "CheckpointMissing",
    "TensorMissing",
    "KernelError",
]


class ReproError(Exception):
    """Base of every typed error the engine raises for a runtime
    invariant.  ``except ReproError`` catches anything ForkBase-shaped
    while letting genuine programming errors (TypeError, ...) escape."""


class ConfigError(ReproError, ValueError):
    """Invalid construction-time configuration (bad mode string, empty
    replica/shard list, nonsensical knob)."""


class InvariantViolation(ReproError, AssertionError):
    """An internal structural invariant does not hold (wrong chunk kind
    on a navigation path, inconsistent piece bounds).  Subclasses
    ``AssertionError`` because these sites were historically ``assert``
    statements — but unlike asserts they survive ``python -O``."""


class ChunkMissing(ReproError, KeyError):
    """A requested cid is not present in the backend (or any replica)."""

    def __init__(self, cid: bytes):
        super().__init__(cid)
        self.cid = cid

    def __str__(self) -> str:
        return f"chunk not found: {self.cid.hex()[:16]}"


class TamperedChunk(ReproError, ValueError):
    """Chunk bytes do not hash to their cid: on-disk or in-flight
    corruption / tampering (the content-addressing invariant is broken)."""

    def __init__(self, cid: bytes, where: str = ""):
        super().__init__(cid)
        self.cid = cid
        self.where = where

    def __str__(self) -> str:
        at = f" during {self.where}" if self.where else ""
        return f"tampered chunk{at}: {self.cid.hex()[:16]}"


class RoutingIndexMiss(ChunkMissing):
    """A read consulted the master chunk-location index and the cid has
    no entry: the chunk was never placed, or a sweep dropped it.  Typed
    (instead of a silent fallback to the hash owner, which holds no copy
    and used to fail from the WRONG node) so callers can distinguish a
    routing-layer miss from a node losing its chunk."""

    def __str__(self) -> str:
        return f"no master-index entry for chunk: {self.cid.hex()[:16]}"


class BranchExists(ReproError, ValueError):
    """Fork/rename target branch name is already taken for this key."""

    def __init__(self, branch: str):
        super().__init__(branch)
        self.branch = branch

    def __str__(self) -> str:
        return f"branch exists: {self.branch}"


class NoSuchRef(ReproError, KeyError):
    """A named branch or version uid does not resolve."""

    def __init__(self, ref):
        super().__init__(ref)
        self.ref = ref

    def __str__(self) -> str:
        return f"no such ref: {self.ref!r}"


class GuardFailed(ReproError):
    """Guarded Put failed: current head != guard_uid (paper §4.5.1)."""


class MergeConflict(ReproError):
    """Three-way merge found concurrent edits it cannot reconcile."""

    def __init__(self, conflicts):
        self.conflicts = conflicts
        super().__init__(f"{len(conflicts)} merge conflict(s)")


class InvalidProof(ReproError, ValueError):
    """The proof does not authenticate its claim against the trusted
    anchor (hash chain broken, navigation inconsistent, claim absent,
    or the bytes fail to parse)."""


class Backpressure(ReproError, RuntimeError):
    """A servlet's admission queue is full (or admission has tightened
    under observed store latency): the client must retry later."""

    def __init__(self, servlet: int, depth: int, bound: int):
        super().__init__(
            f"servlet {servlet} queue full ({depth}/{bound})")
        self.servlet = servlet
        self.depth = depth
        self.bound = bound


class CollectionInFlight(ReproError, RuntimeError):
    """``begin()`` was called while a collection epoch is still active
    (collections over one store are serialized)."""

    def __init__(self, epoch: int, phase):
        super().__init__(
            f"collection already in flight (epoch {epoch}, "
            f"phase {phase})")
        self.epoch = epoch
        self.phase = phase


class CheckpointMissing(NoSuchRef):
    """Checkpoint restore found no committed checkpoint at the ref."""


class TensorMissing(ReproError, KeyError):
    """A checkpoint manifest lacks a tensor the restore template needs
    (writer/reader model shape mismatch)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.name = name

    def __str__(self) -> str:
        return f"missing tensor in checkpoint manifest: {self.name}"


class KernelError(ReproError, RuntimeError):
    """A CUDA kernel could not be built, or its launch was refused
    (``cudaGetLastError`` after the launch was not ``cudaSuccess``)."""
