"""Training launcher.

It runs eagerly on the engine's device (CUDA unless ``--device cpu``); on
the CPU, or with ``--smoke``, it trains the reduced config, as the
reference does on a CPU backend.  Checkpoints stream into ForkBase; any
crash resumes from the branch head, and the steps run under the
controller's deterministic algorithms (runtime/controller.py).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 50 --smoke [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..ckpt import CheckpointStore
from ..configs import ARCHS, smoke as smoke_cfg
from ..kernels import ops
from ..runtime.controller import TrainController
from ..shardings import Sharding
from ..train import AdamWConfig, init_train_state, make_train_step
from ..train.data import SyntheticLM


def main(argv=None) -> TrainController:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--branch", default="run")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the engine's device (default: CUDA)")
    args = ap.parse_args(argv)

    if args.device:
        ops.set_device(args.device)
    dev = ops.ready_device()
    cfg = ARCHS[args.arch]
    if args.smoke or dev.type == "cpu":
        cfg = smoke_cfg(cfg)
    shd = Sharding(None, cfg)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             shards=4, device=dev)
    ds = SyntheticLM(cfg.vocab, args.seq, args.batch,
                     frontend=cfg.frontend, n_patches=cfg.n_patches,
                     d_model=cfg.d_model)
    step = make_train_step(
        cfg, shd, AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps),
        microbatch=1)
    ctl = TrainController(step, state, ds, CheckpointStore(),
                          branch=args.branch, ckpt_every=args.ckpt_every)
    ctl.run(args.steps)
    losses = [l for _, l in ctl.metrics_log]
    print(f"{cfg.name}: {args.steps} steps, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; ckpt dedup "
          f"{ctl.ckpt.dedup_stats.dedup_ratio:.2f}x")
    return ctl


if __name__ == "__main__":
    main()
