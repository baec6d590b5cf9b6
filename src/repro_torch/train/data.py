"""Deterministic synthetic LM data pipeline.

Tokens are a seeded per-step stream (reproducible across restarts — the
data position is part of the checkpoint, so failure recovery resumes at
the exact batch); ``batch_at`` gives the reference's numpy batches byte for
byte.  ``prefetch`` overlaps host generation with device steps: a
background thread fills a bounded queue with batches staged in pinned host
memory, and each batch is copied to the engine's device
(``kernels.ops.ready_device()``) without blocking the host.
``shard_batch`` places a host batch on the engine's device, or on a mesh by
the batch specs.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..errors import ConfigError, InvariantViolation
from ..kernels import ops
from ..mesh import Mesh

_POLL_S = 0.05            # how often a blocked worker looks at its stop flag
_JOIN_S = 10.0            # how long close() waits for the worker to end


class SyntheticLM:
    """Markov-ish synthetic tokens: correlated (so loss is learnable),
    deterministic in (seed, step)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frontend: str = "none",
                 n_patches: int = 0, d_model: int = 0):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.frontend = frontend
        self.n_patches = n_patches
        self.d_model = d_model

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        S = self.seq - (self.n_patches if self.frontend == "vision" else 0)
        base = rng.integers(0, self.vocab, size=(self.batch, S + 1),
                            dtype=np.int32)
        # correlate neighbours so next-token prediction is learnable
        rep = rng.random((self.batch, S + 1)) < 0.5
        shifted = np.roll(base, 1, axis=1)
        tokens = np.where(rep, shifted, base).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.frontend == "vision":
            out["patch_embeds"] = rng.standard_normal(
                (self.batch, self.n_patches, self.d_model),
                dtype=np.float32).astype(np.float32)
        return out

    def prefetch(self, start_step: int, depth: int = 2) -> "Prefetcher":
        """An iterator of (step, batch on the engine's device) from
        ``start_step`` on; ``close()`` stops its thread."""
        return Prefetcher(self, start_step, depth, ops.ready_device())


class Prefetcher:
    """A worker thread puts (step, host batch) into a queue of ``depth``
    items; on a CUDA device the host tensors are pinned, so ``__next__``'s
    copy to the device returns before the copy ends.  An error in the
    worker is raised by the next ``__next__``."""

    def __init__(self, data: SyntheticLM, start_step: int, depth: int,
                 device: torch.device):
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, args=(data, start_step), daemon=True,
            name="synthetic-lm-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, data: SyntheticLM, step: int) -> None:
        pin = self.device.type == "cuda"
        try:
            while not self._stop.is_set():
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in data.batch_at(step).items()}
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                if not self._put((step, host)):
                    return
                step += 1
        except Exception as e:  # noqa: BLE001 — handed to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, dict]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, host = item
        return step, {k: v.to(self.device, non_blocking=True)
                      for k, v in host.items()}

    def close(self) -> None:
        """Stop the worker and wait for it to end."""
        self._stop.set()
        self._thread.join(_JOIN_S)
        if self._thread.is_alive():
            raise InvariantViolation("the prefetch worker did not stop")


def shard_batch(batch: dict, mesh=None, shd=None) -> dict:
    """Host numpy batch -> tensors on the engine's device, or, with a
    ``repro_torch.mesh.Mesh`` and its ``Sharding``, placed by each input's
    spec (dim 0 over the batch axes, ``Mesh.place``): ``DTensor``s on a
    mesh of ranks, whole tensors on a one-device mesh."""
    if mesh is None:
        dev = ops.ready_device()
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in batch.items()}
    if not isinstance(mesh, Mesh) or shd is None:
        raise ConfigError("shard_batch over a mesh takes a "
                          "repro_torch.mesh.Mesh and its Sharding")
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = mesh.place(torch.as_tensor(v),
                            shd.spec("batch", *([None] * (v.ndim - 1))))
    return out
