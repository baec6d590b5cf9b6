"""End-to-end example on the PyTorch port: train a small LM for a few
hundred steps with the FULL production stack — ForkBase-backed
checkpointing, injected failures with deterministic restart, an experiment
fork from a historical step, and tamper-evident lineage.

Run:  python examples/torch/train_with_forkbase_ckpt.py \
          [--steps 200] [--arch tinyllama-1.1b] [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))
import numpy as np
import torch

from repro_torch.ckpt import CheckpointStore
from repro_torch.configs import ARCHS, smoke
from repro_torch.core import ForkBase
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.obs import monotonic
from repro_torch.runtime.controller import FailurePlan, TrainController
from repro_torch.shardings import Sharding
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.data import SyntheticLM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the engine's device (default: CUDA)")
    args = ap.parse_args(argv)
    if args.device:
        ops.set_device(args.device)
    dev = ops.ready_device()

    cfg = smoke(ARCHS[args.arch])
    shd = Sharding(None, cfg)

    def fresh_state():
        return init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                shards=4, device=dev)
    leaves = []
    M.tree_map(leaves.append, fresh_state()["params"])
    print(f"arch={cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model}) "
          f"params~{sum(x.numel() for x in leaves):,}")
    state = fresh_state()
    ds = SyntheticLM(cfg.vocab, args.seq, args.batch)
    step = make_train_step(
        cfg, shd, AdamWConfig(lr=3e-3, warmup_steps=20,
                              total_steps=args.steps))

    ckpt = CheckpointStore(ForkBase())
    fail_at = {args.steps // 3, 2 * args.steps // 3}
    ctl = TrainController(step, state, ds, ckpt, branch="run",
                          ckpt_every=20,
                          failure_plan=FailurePlan(set(fail_at)))
    print(f"training {args.steps} steps, failures injected at {fail_at}")
    t0 = monotonic()
    try:
        ctl.run(args.steps)
    except KeyboardInterrupt:
        pass
    dt = monotonic() - t0
    losses = [l for _, l in ctl.metrics_log]
    print(f"done in {dt:.1f}s ({dt / max(1, len(losses)):.2f}s/step) | "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} | "
          f"restarts={ctl.restarts}")

    # experiment fork from the middle of the run (warm restart)
    mid = (args.steps // 2) // 20 * 20
    ctl.fork_experiment("lr-sweep", from_step=mid)
    ckpt.restore(ctl.state, "lr-sweep")
    print(f"forked 'lr-sweep' from step {mid} "
          f"(zero-copy: POS-Tree chunks shared)")

    st = ckpt.dedup_stats
    print(f"checkpoint store: {st.logical_bytes / 1e6:.1f}MB logical -> "
          f"{st.physical_bytes / 1e6:.1f}MB physical "
          f"({st.dedup_ratio:.2f}x dedup, {st.dedup_hits} chunk hits)")
    hist = ckpt.history("run", 100)
    ok = ckpt.verify(hist[0][0], hist[-1][0])
    print(f"lineage: {len(hist)} checkpoints; head verifiably derives "
          f"from step-0 commit: {ok}")
    return ctl


if __name__ == "__main__":
    main()
