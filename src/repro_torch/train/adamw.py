"""AdamW from scratch (no torch.optim): bf16 compute params + fp32 master
copy, fp32 moments (bf16 where the config asks), decoupled weight decay,
global-norm clipping, cosine LR with linear warmup.

Every function is pure: ``apply_adamw`` returns new tensors and leaves its
arguments as they were, so two runs may start from one state (a restart
replays from a checkpoint, a microbatch check runs twice from one init).
The arithmetic is the reference's, operation for operation and in float32,
so both packages round at the same places; ``torch.optim.AdamW`` rounds in
another order.  Leaves are visited in JAX's flattening order
(``ckpt.store._leaf_paths``), which fixes the order of the global norm's
sum.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ckpt.store import _leaf_paths, _unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # moment storage dtype: 'f32' or 'bf16' (8-bit-Adam-style compression
    # for the 100B-class archs; math still runs in fp32)
    moment_dtype: str = "f32"


def _leaves(tree) -> list:
    return [leaf for _, leaf in _leaf_paths(tree)]


def schedule(opt: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor or int), float32 on
    the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, opt.warmup_steps), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(1, opt.total_steps - opt.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = opt.min_lr_frac + (1 - opt.min_lr_frac) * cos
    return opt.lr * warm * frac


def init_opt_state(params, moment_dtype: str = "f32") -> dict:
    """Zero moments in ``moment_dtype`` and a float32 master copy of every
    leaf (a copy even where the leaf is float32 already), each placed as
    its leaf is (same device, or the same ``DTensor`` placements); the
    step count is replicated."""
    mdt = torch.bfloat16 if moment_dtype == "bf16" else torch.float32
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros():
        return _unflatten(params, iter(
            [torch.zeros_like(p, dtype=mdt) for p in leaves]))
    master = _unflatten(params, iter(
        [p.detach().to(torch.float32, copy=True) for p in leaves]))
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if leaves and _is_dtensor(leaves[0]):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = leaves[0].device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {"mu": zeros(), "nu": zeros(), "master": master, "step": step}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed one after another in the reference's order.  A leaf sharded
    over ranks sums its shards first (an all-reduce a leaf), so every
    rank holds the same norm, a plain tensor."""
    total = 0
    for leaf in _leaves(tree):
        sq = torch.sum(leaf.to(torch.float32) ** 2)
        total = total + (sq.full_tensor() if _is_dtensor(sq) else sq)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_adamw(opt: AdamWConfig, params, opt_state: dict, grads):
    """One AdamW step.  Returns (new params, new optimizer state, {"lr",
    "gnorm"}); the new params are copies of the new master weights cast to
    each param's dtype (never the master tensors themselves)."""
    step = opt_state["step"]
    lr = schedule(opt, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - opt.b1 ** t
    bc2 = 1 - opt.b2 ** t

    def upd(g, mu, nu, m):
        g = g.to(torch.float32) * scale
        mdt = mu.dtype
        mu2 = opt.b1 * mu.to(torch.float32) + (1 - opt.b1) * g
        nu2 = opt.b2 * nu.to(torch.float32) + (1 - opt.b2) * g * g
        update = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + opt.eps)
        wd = opt.weight_decay if m.ndim >= 2 else 0.0
        m2 = m - lr * (update + wd * m)
        return mu2.to(mdt), nu2.to(mdt), m2

    out = [upd(g, mu, nu, m) for g, mu, nu, m in zip(
        _leaves(grads), _leaves(opt_state["mu"]), _leaves(opt_state["nu"]),
        _leaves(opt_state["master"]))]
    mu2 = _unflatten(grads, iter([o[0] for o in out]))
    nu2 = _unflatten(grads, iter([o[1] for o in out]))
    m2 = _unflatten(grads, iter([o[2] for o in out]))
    new_params = _unflatten(params, iter(
        [o[2].to(p.dtype, copy=True)
         for o, p in zip(out, _leaves(params))]))
    return new_params, {"mu": mu2, "nu": nu2, "master": m2,
                        "step": step + 1}, {"lr": lr, "gnorm": gnorm}
