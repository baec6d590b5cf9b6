"""The ``tree.splice`` span attributes of one untraced run of a cell.

    python3 experiments/torch/splice_attrs.py --workload <cell> --seed <n> \
        [--seconds 51] [--tiny]

Runs the cell once as ``bench/run.py --trace 0`` does (``run_cell``), then
reads the program's ``tree.splice`` spans (``repro_torch.obs.SPANS``) of the
run, all but the set-up's first, and prints one JSON object: the run's
``correct``, metrics and completed operations, the number of splices, the
end of the newest span the ring dropped, and for each attribute (``edits``,
``clusters``, ``attempts``, ``leaves_read``, ``rechunked``,
``new_leaves``) its minimum, quartiles, maximum and mean over the splices.
``--tiny`` runs the cell at the benchmark tests' small size on the CPU;
otherwise it needs one CUDA card, and keeps to one core and one torch
thread, as the benchmark does.
"""
import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ATTRS = ("edits", "clusters", "attempts", "leaves_read", "rechunked",
         "new_leaves")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.run import pin_to_one_core
    pin_to_one_core()

    import torch
    torch.set_num_threads(1)
    from bench.harness.runner import run_cell
    from repro_torch import obs

    kw = {}
    if args.tiny:
        from bench.tests import tiny
        kw = dict(device="cpu", bench=tiny.bench(),
                  config=tiny.config_of(args.workload),
                  traffic=tiny.traffic_of(args.workload))
    elif not torch.cuda.is_available():
        print("needs a CUDA card, or --tiny", file=sys.stderr)
        return 2
    result, details = run_cell(args.workload, args.seed, args.seconds,
                               False, **kw)
    spans = [s for s in obs.SPANS.spans() if s.name == "tree.splice"][1:]
    out = {"correct": result["correct"], "metrics": result["metrics"],
           "completed": details["completed"], "splices": len(spans),
           "dropped_end_ns": obs.SPANS.dropped_end_ns}
    for k in ATTRS:
        v = [s.attrs.get(k, 0) for s in spans]
        if v:
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
            out[k] = {"min": min(v), "q1": q[0], "median": q[1], "q3": q[2],
                      "max": max(v), "mean": statistics.fmean(v)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
