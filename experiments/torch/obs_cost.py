"""The cost of recording: one cell's operation with the program's
observability on against off, in one process, in pairs of operations.

    python3 experiments/torch/obs_cost.py --workload <cell> --seed <n> \
        [--pairs 40] [--out <file.json>]

Sets the cell up as ``bench/run.py`` does, then runs its operation
``2 × pairs`` times, switching ``obs.REGISTRY.enabled`` (the flag that
``REPRO_OBS=0`` clears at import) before each, in the order on, off,
off, on, on, off, ... so that a drift of the host in time falls on both
halves alike.  A pair is two adjacent operations, one of each.  Prints
one JSON object: each pair's host time on ÷ off − 1, the median and
quartiles of those, and each half's median time (also written to
``--out`` when given).  The span ring keeps what it holds in both
halves; its collector cost is not part of the difference.  Needs one
CUDA card; keeps to one core and one torch thread, as the benchmark.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.run import pin_to_one_core
    pin_to_one_core()

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    from bench.harness import core
    from repro_torch import obs
    from repro_torch.kernels import ops

    bench = core.load_benchmark(core.BENCH_DIR.parent)
    cell = core.cell_of(bench, args.workload)
    config = core.load_config(cell["config"], core.BENCH_DIR)
    traffic = core.load_traffic(cell["traffic"], core.BENCH_DIR)
    ops.set_device("cuda")
    family = core.family(config["family"], core.BENCH_DIR)(
        config, traffic, args.seed)
    op = core.operation(traffic["op"], core.BENCH_DIR)
    spans = core.Spans(False)
    family.setup(spans)
    op(family, spans)                       # warm every path, both ways
    obs.REGISTRY.enabled = False
    op(family, spans)
    torch.cuda.synchronize()

    times = {True: [], False: []}
    for k in range(2 * args.pairs):
        on = (k % 4) in (0, 3)
        obs.REGISTRY.enabled = on
        t = time.perf_counter()
        op(family, spans)
        torch.cuda.synchronize()
        times[on].append(time.perf_counter() - t)
    obs.REGISTRY.enabled = True
    ratios = [a / b - 1.0 for a, b in zip(times[True], times[False])]
    q1, med, q3 = statistics.quantiles(ratios, n=4)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0), "pairs": args.pairs,
        "on_over_off_median_pct": 100.0 * statistics.median(ratios),
        "on_over_off_quartiles_pct": [100.0 * q1, 100.0 * med,
                                      100.0 * q3],
        "on_median_s": statistics.median(times[True]),
        "off_median_s": statistics.median(times[False]),
        "on_over_off_pct": [100.0 * r for r in ratios],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
