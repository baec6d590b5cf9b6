"""Prefill time of one architecture under two source trees of the port, on
one GPU, in the order A, B, B, A (each run a fresh process).

    python3 experiments/torch/prefill_ab.py --arch xlstm-125m \
        --seq 128,2048 <src dir A> <src dir B>

A source tree is a directory that holds ``repro_torch`` (the repo's
``src``, or the ``src`` of an unpacked ``git archive`` of another commit).
Each run builds the arch's published config (all its layers) in bf16 from
seed 0, then for each prompt length takes a warm-up prefill at batch
BATCH and the median of REPEATS timed ones.  Prints one JSON
line a run, then the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

BATCH, REPEATS = 2, 5


def run_one(arch: str, seqs: list[int]) -> dict:
    import torch

    import repro_torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.shardings import Sharding

    dev = torch.device("cuda")
    ops.set_device(dev)
    cfg = ARCHS[arch]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           shards=4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {"module": repro_torch.__file__}
    for S in seqs:
        toks = torch.randint(0, cfg.vocab, (BATCH, S), generator=gen,
                             device=dev, dtype=torch.int32)
        times = []
        with torch.no_grad():
            for _ in range(REPEATS + 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                M.prefill(params, {"tokens": toks}, cfg, Sharding(None, cfg))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        times = sorted(times[1:])
        out[str(S)] = {"median_s": times[len(times) // 2], "times_s": times}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--seq", default=[128], help="prompt lengths, "
                    "comma-separated", type=lambda v: [int(x) for x in
                                                       v.split(",")])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("src", nargs="+")
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, args.src[0])
        print(json.dumps(run_one(args.arch, args.seq)))
        return 0
    if len(args.src) != 2:
        ap.error("give two source trees, A and B")
    a, b = (os.path.abspath(s) for s in args.src)
    for label, src in (("A", a), ("B", b), ("B", b), ("A", a)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--arch", args.arch, "--seq", ",".join(map(str, args.seq)),
             src], capture_output=True, text=True, check=True)
        print(json.dumps({"run": label, "src": src, "arch": args.arch,
                          "batch": BATCH,
                          "prefill": json.loads(res.stdout.splitlines()[-1])}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
