"""One benchmark cell at another scale of its deployment: the set-up time
and a short window, on the card.

    python3 experiments/torch/setup_at_scale.py --workload <cell> \
        --seed <n> --scale <n> [--seconds 5]

Runs the cell as ``bench/run.py`` does, with its config's scale key (the
key its family's ``faults/<family>.py`` names in ``TEST_SCALE``, such as
``records``) set to ``--scale``, and prints one JSON object: the scale,
``setup_s`` (process start to the first timed operation, as in the
benchmark), the window's operations, the run's ``correct`` and checks,
its metrics and the card.  Needs one CUDA card; keeps to one core and one
torch thread, as the benchmark.
"""
import time

T_START = time.perf_counter()

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--scale", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.run import pin_to_one_core
    pin_to_one_core()

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    from bench import control
    from bench.harness import core
    from bench.harness.runner import run_cell

    bench = core.load_benchmark()
    config = core.load_config(core.cell_of(bench, args.workload)["config"])
    key = control.faults_of(config["family"]).TEST_SCALE[0]
    config[key] = args.scale
    result, details = run_cell(args.workload, args.seed, args.seconds, False,
                               t_start=T_START, bench=bench, config=config)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, key: args.scale,
        "setup_s": result["metrics"].get("setup_s", {}).get("value"),
        "completed": details["completed"], "elapsed_s": details["elapsed_s"],
        "correct": result["correct"], "checks": result["checks"],
        "metrics": result["metrics"], "device": result["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
