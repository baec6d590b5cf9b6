"""Serving launcher: batched prefill + greedy decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 64 --gen 32 [--smoke] [--device cuda|cpu]

It runs eagerly on the engine's device (CUDA unless ``--device cpu``); on
the CPU it serves the smoke config, as the reference does on a CPU
backend.  The cache holds every position the run writes: the prompt (with
the VLM's patches) and the generated tokens.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ARCHS, smoke as smoke_cfg
from ..errors import InvariantViolation
from ..kernels import ops
from ..models import model as M
from ..obs import monotonic
from ..shardings import Sharding


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_batch(cfg, B: int, S: int, gen: torch.Generator, device) -> dict:
    """Seeded prompts (B, S) of in-vocab tokens; the VLM also gets zero
    patch embeddings (B, n_patches, d_model), as the reference serves."""
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         device=gen.device, dtype=torch.int32).to(device)
    batch = {"tokens": toks}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model),
                                            dtype=torch.bfloat16,
                                            device=device)
    return batch


def generate(params, batch: dict, cfg, shd, gen: int) -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps.  Returns the tokens
    (B, gen), the last logits, and the seconds of the prefill and of the
    decode loop (each ending in a device synchronisation)."""
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    pos0 = S + (cfg.n_patches if cfg.frontend == "vision" else 0)
    T = pos0 + gen
    _sync(dev)
    t0 = monotonic()
    cache, logits = M.prefill(params, batch, cfg, shd, cache_len=T)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(dev)
    t_prefill = monotonic() - t0
    out = [tok]
    t0 = monotonic()
    for i in range(gen - 1):
        pos = torch.full((B,), pos0 + i, dtype=torch.int32, device=dev)
        cache, logits = M.decode_step(params, cache,
                                      {"tokens": tok, "pos": pos}, cfg, shd)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": monotonic() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
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
    rng = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, rng, shards=4, device=dev)
    B, S = args.batch, args.prompt_len
    with torch.no_grad():
        run = generate(params, make_batch(cfg, B, S, rng, dev), cfg, shd,
                       args.gen)
    toks = run["tokens"].cpu()
    if not (bool((toks < cfg.vocab).all())
            and bool(torch.isfinite(run["logits"].float()).all())):
        raise InvariantViolation("greedy decode left the vocabulary or "
                                 "produced non-finite logits")
    dt = run["decode_s"]
    print(f"{cfg.name}: prefill({B}x{S}) {run['prefill_s']:.2f}s; "
          f"decode {args.gen} tokens {dt:.2f}s "
          f"({B * (args.gen - 1) / max(dt, 1e-9):.1f} tok/s); "
          f"sample: {toks[0, :12].tolist()}")


if __name__ == "__main__":
    main()
