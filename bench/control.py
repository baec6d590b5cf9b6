"""Run a cell's control, or a planted fault, on the card and print what the
judge reads: the check that decides ``correct`` must come out false.

    python3 bench/control.py --workload <name> --fault <fault> --seeds 1 2 3 [--seconds 5]

Each seed is one run of the cell at its own size, in this process, with a
short window.  A fault is planted once the set-up is done, from outside the
family: it wraps the program's objects the family holds.  A family's
controls and faults are the functions of ``faults/<family>.py``, found by
the config's ``family`` as ``families/<family>.py`` is; that file also
says which controls a cell has (PERF.md §2) and which of the faults
``unchanged_state``, ``half_batch`` and ``altered_answer`` apply to its
mix.  Prints one JSON line a seed and exits 1 if any run comes out
correct.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = Path(ROOT) / "bench"


def flip(b: bytes) -> bytes:
    """``b`` with its first bit flipped: an answer altered."""
    return bytes([b[0] ^ 1]) + b[1:]


def faults_of(family: str, bench_dir: Path = BENCH_DIR):
    """The module ``faults/<family>.py``: its control and fault functions
    by name, ``controls(config, traffic)``, ``faults(config, traffic)``
    and ``TEST_SCALE``."""
    from bench.harness import core
    mod = core._module("faults", family, bench_dir)
    if mod is None:
        raise FileNotFoundError(f"no faults of family {family!r}")
    return mod


def fault(family: str, name: str, bench_dir: Path = BENCH_DIR):
    """The function that plants fault ``name`` in a family ``family``."""
    plant = getattr(faults_of(family, bench_dir), name, None)
    if plant is None:
        raise KeyError(f"no fault {name!r} of family {family!r}")
    return plant


def controls(config: dict, traffic: dict,
             bench_dir: Path = BENCH_DIR) -> tuple[str, ...]:
    """The controls of a cell of ``config`` under ``traffic``; the first
    is "the control"."""
    return faults_of(config["family"], bench_dir).controls(config, traffic)


def faults(config: dict, traffic: dict,
           bench_dir: Path = BENCH_DIR) -> tuple[str, ...]:
    """The faults that apply to a cell of ``config`` under ``traffic``."""
    return faults_of(config["family"], bench_dir).faults(config, traffic)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.harness import core
    from bench.harness.runner import run_cell

    cell = core.cell_of(core.load_benchmark(), args.workload)
    config = core.load_config(cell["config"])
    traffic = core.load_traffic(cell["traffic"])
    known = faults(config, traffic) + controls(config, traffic)
    if args.fault not in known:
        print(f"{args.workload} has no fault {args.fault!r}; it has "
              f"{', '.join(known)}", file=sys.stderr)
        return 2
    plant = fault(config["family"], args.fault)
    caught = True
    for seed in args.seeds:
        result, details = run_cell(args.workload, seed, args.seconds, False,
                                   plant=plant)
        caught &= not result["correct"]
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": result["correct"],
                          "completed": details["completed"],
                          "checks": result["checks"]}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
