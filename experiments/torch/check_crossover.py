"""Where checking a batch of chunks with one batched hash starts to pay:
``storage.backend.check_chunks`` forced onto each of its two routes, at
batch sizes from 1 up, on one CUDA card.

    python3 experiments/torch/check_crossover.py [--reps 300] [--passes 2] \
        [--out <file.json>]

The single route checks chunk by chunk (``cid_of``: one ``fphash_host``
launch from pinned memory and one wait a chunk); the batched route hashes
the batch with one ``content_hash_many`` call (a join, three
host-to-device copies, one ``fphash_many`` launch, the digests back).
For each chunk size (a 64-byte meta chunk, a 2 KB index node, a
4,097-byte leaf) and batch size, the two routes run in turns (single,
batched, batched, single, ...) over the same chunks, each call timed on
the host clock after 50 unmeasured calls; the median of each route's
calls is kept.  The whole grid is measured ``--passes`` times.  Prints one
JSON object: each pass's medians in µs a batch, and per pass and chunk
size the smallest batch from which the batched route is faster at that
size and every larger one (``crossover``), then the card's name and power
limit.  Keeps to one core and one torch thread, as the benchmark does.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZES = (64, 2048, 4097)
BATCHES = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64)
WARM = 50


def measure(backend, hashing, rng, reps: int) -> dict:
    """Median µs a call of each route, by ``<size>x<batch>``."""
    routes = {"single": 1 << 30, "batched": 1}
    order = ["single", "batched", "batched", "single"]
    medians = {}
    for size in SIZES:
        for n in BATCHES:
            raws = [rng.bytes(size) for _ in range(n)]
            cids = hashing.content_hash_many(raws)
            st = backend.StoreStats()
            times = {name: [] for name in routes}
            for rep in range(reps + WARM):
                name = order[rep % 4]
                backend.CHECK_BATCH_MIN = routes[name]
                t = time.perf_counter()
                bad = backend.check_chunks(st, raws, cids)
                dt = time.perf_counter() - t
                if bad is not None:
                    raise SystemExit(f"{name} route failed a clean batch")
                if rep >= WARM:
                    times[name].append(dt)
            medians[f"{size}x{n}"] = {
                name: statistics.median(ts) * 1e6
                for name, ts in times.items()}
    return medians


def crossover_of(medians: dict, size: int):
    """The smallest batch from which the batched route is faster at every
    batch measured, or None."""
    faster = [medians[f"{size}x{n}"]["batched"]
              < medians[f"{size}x{n}"]["single"] for n in BATCHES]
    return next((n for i, n in enumerate(BATCHES) if all(faster[i:])), None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.run import pin_to_one_core
    pin_to_one_core()

    import numpy as np
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    from repro_torch.core import hashing
    from repro_torch.kernels import build, ops
    from repro_torch.storage import backend
    build.build_all()
    ops.set_device("cuda")
    hashing.use_fphash()
    rng = np.random.default_rng(0)
    passes = [measure(backend, hashing, rng, args.reps)
              for _ in range(args.passes)]
    crossover = [{size: crossover_of(medians, size) for size in SIZES}
                 for medians in passes]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"median_us": passes, "crossover": crossover,
           "reps": args.reps, "card": card.strip(),
           "device": torch.cuda.get_device_name(0)}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
