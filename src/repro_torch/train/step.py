"""The training step: gradients of the model loss by autograd, an AdamW
update, and optional microbatch gradient accumulation.

The returned step function is pure, (state, batch) -> (state, metrics):
the state's tensors are never written, so a restart may replay a step from
a restored copy, and two steps may start from one state.  It runs eagerly
on the state's device.  With ``microbatch > 1`` the gradients of the batch
slices accumulate in ``grad_dtype`` (bfloat16 by default) and are divided
by the count there, as the reference's ``lax.scan`` does.

On a mesh of ranks the state and batch are ``DTensor``s: each gradient
comes back in its param's placements (the data-parallel mean is the
all-reduce of a replicated param's partial sums), and microbatches slice
each rank's own rows.

On the card, scaled_dot_product_attention's backward adds dq with atomics
in no fixed order, so two runs of a step can differ in the last bits; a
replay is bit-exact under ``runtime.deterministic()``, which the training
controller's ``run`` enters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ckpt.store import _leaf_paths, _unflatten
from ..errors import ConfigError
from ..models import model as model_mod
from .adamw import AdamWConfig, apply_adamw, init_opt_state


@dataclass
class TrainState:
    params: Any
    opt: Any

    def tree(self):
        return {"params": self.params, "opt": self.opt}


def init_train_state(cfg, gen: torch.Generator, shards: int = 16,
                     device=None, shd=None) -> dict:
    """Random params of ``cfg`` drawn by ``gen`` (``models.model.
    init_params``) on ``device`` (default: the engine's device), or placed
    by ``shd``'s param specs on a mesh of ranks, with a fresh optimizer
    state placed as the params are."""
    params = model_mod.init_params(cfg, gen, shards, device=device, shd=shd)
    return {"params": params,
            "opt": init_opt_state(params,
                                  getattr(cfg, "opt_moments", "f32"))}


def state_from_numpy(tree, device=None) -> dict:
    """A train state of numpy arrays (the reference's, for example: params,
    opt/mu, opt/nu, opt/master and opt/step, taken leaf by leaf with
    ``np.asarray``) as tensors on ``device`` (default: the engine's
    device), bfloat16 leaves bit for bit."""
    return model_mod.params_from_numpy(tree, device=device)


def loss_fn(params, batch, cfg, shd):
    loss, metrics = model_mod.train_loss(params, batch, cfg, shd)
    return loss, metrics


def _metric(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def value_and_grad(params, batch, cfg, shd):
    """(loss, metrics, grads): the loss and its metrics detached, and the
    gradient of the loss with respect to every leaf of ``params`` (a tree
    like ``params``, each leaf in its param's dtype; zeros for a leaf the
    loss does not reach)."""
    named = _leaf_paths(params)
    for name, p in named:
        if not p.is_floating_point():
            raise ConfigError(f"param {name} has dtype {p.dtype}: the loss "
                              f"is differentiated by every param")
    leaves = [p.detach().requires_grad_() for _, p in named]
    with torch.enable_grad(), shd.region():
        loss, metrics = loss_fn(_unflatten(params, iter(leaves)), batch, cfg,
                                shd)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _as_placed(g, p)
             for g, p in zip(grads, leaves)]
    loss = loss.detach()
    return (loss, {k: _metric(v, loss) for k, v in metrics.items()},
            _unflatten(params, iter(grads)))


def _as_placed(g, p):
    """A gradient in its param's placements.  On a mesh of ranks a
    replicated param's gradient comes back as partial sums over the batch
    axes; their all-reduce is the data-parallel mean (the loss is the mean
    over the whole batch)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local_rows(x, i: int, n_slices: int):
    """Slice i of n_slices of ``x``'s rows.  A ``DTensor`` is sliced on
    each rank's own rows (the batch stays where it is; a microbatch holds
    local rows i * n .. of every rank)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        local = x.to_local()
        n = local.shape[0] // n_slices
        return DTensor.from_local(local[i * n:(i + 1) * n], x.device_mesh,
                                  x.placements, run_check=False)
    n = x.shape[0] // n_slices
    return x[i * n:(i + 1) * n]


def make_train_step(cfg, shd, opt_cfg: AdamWConfig | None = None,
                    microbatch: int = 1, grad_dtype=torch.bfloat16):
    """microbatch > 1 loops over batch slices accumulating ``grad_dtype``
    grads — trades time for activation memory (fp32 accumulation happens in
    AdamW)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(state, batch):
        params = state["params"]
        if microbatch == 1:
            loss, metrics, grads = value_and_grad(params, batch, cfg, shd)
        else:
            def mb_slice(i):
                return {k: _local_rows(x, i, microbatch)
                        for k, x in batch.items()}

            g_acc = [torch.zeros_like(p, dtype=grad_dtype)
                     for _, p in _leaf_paths(params)]
            loss_sum = 0.0
            for i in range(microbatch):
                loss_i, metrics, g = value_and_grad(params, mb_slice(i), cfg,
                                                    shd)
                g_acc = [a + b.to(grad_dtype) for a, (_, b) in
                         zip(g_acc, _leaf_paths(g))]
                loss_sum = loss_sum + loss_i
            grads = _unflatten(params, iter([g / microbatch for g in g_acc]))
            loss = loss_sum / microbatch
        with torch.no_grad():
            new_params, new_opt, om = apply_adamw(opt_cfg, params,
                                                  state["opt"], grads)
        metrics = dict(metrics, loss=loss, **om)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_eval_step(cfg, shd):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch, cfg, shd)
        return dict({k: _metric(v, loss) for k, v in metrics.items()},
                    loss=loss)
    return eval_step
