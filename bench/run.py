"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (``src/``) and
``BENCHMARK.json``.  Needs one CUDA card per chip the cell names; without
them it prints no result and exits 2.  Earlier lines of standard output
carry the run's details; the last is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number the judge compared, beside
its limit).  The same numbers end standard error.  The process keeps to
one core and one torch thread, so the host's scheduler does not move the
program's single host thread between cores.
"""
import time

# setup_s counts from here, before any other import: as near to the
# process's start as the script can see
T_START = time.perf_counter()

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pin_to_one_core() -> int:
    """Keeps the process, and every thread it starts later, on one fixed
    core (the highest it may use), so that the program's single host
    thread does not move between cores; returns the core."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    pin_to_one_core()

    import torch
    torch.set_num_threads(1)

    from bench.harness import core
    from bench.harness.runner import run_cell

    bench = core.load_benchmark()
    chips = core.cell_of(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, details = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START,
                               bench=bench)
    bad = core.forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(details))
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
