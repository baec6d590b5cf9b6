"""Fault-tolerant training controller.

  * periodic ForkBase checkpoints (cheap: chunk-dedup makes the marginal
    checkpoint cost proportional to what actually changed);
  * failure injection + restart: on any step failure the controller
    restores the last committed version and replays — the data pipeline is
    positioned from the checkpoint's step, and ``run`` steps under
    ``deterministic()``, so training is bit-deterministic across restarts;
  * fork-on-conflict resolution: when several pod controllers race commits
    of the same run, the UB-table holds every head; the controller
    resolves by data progress and continues on the merged head;
  * elastic restarts: the checkpoint is placement-agnostic; ``remesh``
    restores onto whatever devices survive, sharded by the new mesh.

Batches land on the engine's device (``kernels.ops.device()``: the card
unless the caller selected the CPU).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import torch

from ..ckpt import CheckpointStore
from ..errors import CheckpointMissing
from ..kernels import ops


class SimulatedFailure(RuntimeError):
    pass


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block (the
    previous setting restored after; the setting is process-wide).  On the
    card it picks deterministic forms of the backward kernels that add
    with atomics (scaled_dot_product_attention's dq varies between runs
    without it).  Deterministic matrix products need
    ``CUBLAS_WORKSPACE_CONFIG``, set here when the caller has not: torch
    reads it at each product, cuBLAS's workspace is sized by its value at
    the process's first product."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


@dataclass
class FailurePlan:
    """Inject failures at the given global steps (once each)."""
    at_steps: set = field(default_factory=set)
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class TrainController:
    def __init__(self, step_fn, init_state, dataset, ckpt: CheckpointStore,
                 branch: str = "run", ckpt_every: int = 10,
                 failure_plan: FailurePlan | None = None):
        self.step_fn = step_fn
        self.state = init_state
        self.dataset = dataset
        self.ckpt = ckpt
        self.branch = branch
        self.ckpt_every = ckpt_every
        self.failures = failure_plan or FailurePlan()
        self.step = 0
        self.restarts = 0
        self.metrics_log: list = []
        # initial commit so restarts always have a base
        self.ckpt.save(self.state, branch, step=0)

    # ------------------------------------------------------------ loop
    def run(self, n_steps: int, max_restarts: int = 10):
        """Step to ``n_steps`` under ``deterministic()``, restoring the
        branch head and replaying after each failure."""
        with deterministic():
            while self.step < n_steps:
                try:
                    self._run_segment(n_steps)
                except SimulatedFailure:
                    self.restarts += 1
                    if self.restarts > max_restarts:
                        raise
                    self._restore()
        return self.state

    def _run_segment(self, n_steps: int):
        while self.step < n_steps:
            self.failures.maybe_fail(self.step)
            batch = {k: torch.as_tensor(v, device=ops.device())
                     for k, v in self.dataset.batch_at(self.step).items()}
            self.state, m = self.step_fn(self.state, batch)
            self.metrics_log.append((self.step, float(m["loss"])))
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.state, self.branch, step=self.step)

    def _restore(self):
        self.state = self.ckpt.restore(self.state, self.branch)
        head = self.ckpt.db.get(self.ckpt.key, self.branch)
        self.step = self.ckpt.step_of(head.uid)

    # ------------------------------------------------ elastic / forking
    def remesh(self, mesh, specs):
        """Elastic restart: reload the current branch head onto a new
        placement (``mesh`` a ``torch.device`` or a
        ``repro_torch.mesh.Mesh``, the state placed by ``specs``; on a mesh
        of ranks rank 0's store is read, see ``CheckpointStore.restore``).
        The new mesh need not have the writer's shape: (2, 2) -> (1, 2)
        is a restart on half the devices."""
        self.state = self.ckpt.restore(self.state, self.branch, mesh=mesh,
                                       specs=specs)
        return self.state

    def fork_experiment(self, new_branch: str, from_step: int | None = None):
        """FoD: warm-start a new experiment branch from any version."""
        if from_step is None:
            self.ckpt.fork(self.branch, new_branch)
        else:
            for uid, meta in self.ckpt.history(self.branch, 1 << 20):
                if meta.get("step") == from_step:
                    self.ckpt.fork(uid, new_branch)
                    return
            raise CheckpointMissing(f"no checkpoint at step {from_step}")


def run_resilient(step_fn, init_state, dataset, *, n_steps: int,
                  fail_at=(), ckpt_every: int = 10,
                  db=None) -> TrainController:
    ckpt = CheckpointStore(db) if db is not None else CheckpointStore()
    ctl = TrainController(step_fn, init_state, dataset, ckpt,
                          ckpt_every=ckpt_every,
                          failure_plan=FailurePlan(set(fail_at)))
    ctl.run(n_steps)
    return ctl
