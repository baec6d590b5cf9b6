"""Idle gaps of one cell's traced window, named by the program's own spans.

    python3 experiments/torch/idle_by_span.py --workload <cell> --seed <n> \
        [--seconds 51] [--out <file.json>]

Runs the cell once as ``bench/run.py --trace 1`` does (``run_cell``), but
hands ``bench/harness/trace.py``'s ``DeviceTrace.stop`` the program's spans
(``repro_torch.obs.SPANS``, laid on the Unix clock by ``obs.unix_ns``)
where the benchmark hands it the harness's, so every idle gap of the card
is named by the innermost program span the host was in.  Also measures,
from the same trace, the share of each kernel's device time that lies
inside the spans of each name (at any depth).  Prints the run's result
line, then one JSON object (also written to ``--out`` when given).  Needs one CUDA
card; the run keeps to one core and one torch thread, as the benchmark's.
"""
import argparse
import json
import os
import sys
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# shares of kernel device time the write and read paths should hold
CHECKS = {"chunker_kernel in splice.chunk": ("chunker_kernel",
                                             ("splice.chunk",)),
          "fphash_host_kernel in the write path": (
              "fphash_host_kernel",
              ("splice.gather", "buffer.flush", "tier.flush")),
          "fphash_host_kernel in the read path": (
              "fphash_host_kernel", ("tree.read", "tree.load"))}


def program_spans(lo: int, hi: int) -> list[tuple[str, int, int]]:
    """The program's finished spans that overlap [lo, hi) (Unix ns), as
    ``(name, start, end)`` on the Unix clock; raises when the ring
    dropped a span that ended inside the window or later."""
    from repro_torch import obs
    ring = obs.SPANS
    if ring.dropped_end_ns and obs.unix_ns(ring.dropped_end_ns) >= lo:
        raise RuntimeError("the span ring dropped spans of the window")
    out = []
    for sp in ring.spans():
        a, b = obs.unix_ns(sp.start_ns), obs.unix_ns(sp.end_ns)
        if b > lo and a < hi:
            out.append((sp.name, a, b))
    return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(intervals, union) -> int:
    """Time the intervals spend inside ``union`` (sorted, disjoint), in
    one sweep over both."""
    total, j = 0, 0
    for a, b in sorted(intervals):
        while j < len(union) and union[j][1] <= a:
            j += 1
        k = j
        while k < len(union) and union[k][0] < b:
            total += min(b, union[k][1]) - max(a, union[k][0])
            k += 1
    return total


def share_inside(events, spans) -> dict[str, dict[str, float]]:
    """For each event name, the share of its time ``[a, b)`` inside the
    union of the spans of each name: ``{event: {span name: share}}``.
    ``events`` and ``spans`` are ``(name, start, end)``."""
    unions = {n: _union((a, b) for m, a, b in spans if m == n)
              for n in {s[0] for s in spans}}
    by_name = defaultdict(list)
    for name, a, b in events:
        by_name[name].append((a, b))
    out = {}
    for name, ivs in by_name.items():
        total = sum(b - a for a, b in ivs)
        if total:
            shares = {n: _inside(ivs, u) / total for n, u in unions.items()}
            out[name] = {n: x for n, x in shares.items() if x}
    return out


def kernel_share(events, spans, kernels: dict) -> dict[str, dict]:
    """``share_inside`` over the kernels the benchmark counts
    (``trace.KERNELS``: its groups and their entry functions), each
    kernel's events gathered under its entry function's name and each
    group's under the group's."""
    named = []
    for name, a, b in events:
        for group, entries in kernels.items():
            for entry in entries:
                if entry in name:
                    named += [(entry, a, b), (group, a, b)]
    return share_inside(named, spans)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
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

    from bench.harness import trace
    from bench.harness.runner import run_cell

    seen = {}

    class ProgramSpanTrace(trace.DeviceTrace):
        def stop(self, start_ns, end_ns, spans):
            prog = program_spans(start_ns, end_ns)
            out = super().stop(start_ns, end_ns, prog)
            cuda = torch.autograd.DeviceType.CUDA
            events = []
            for ev in self.prof.profiler.kineto_results.events():
                if ev.device_type() != cuda:
                    continue
                a = max(ev.start_ns(), start_ns)
                b = min(ev.start_ns() + ev.duration_ns(), end_ns)
                if b > a:
                    events.append((ev.name(), a, b))
            checks = {}
            for label, (kern, names) in CHECKS.items():
                spans_of = [(label, a, b) for n, a, b in prog if n in names]
                checks[label] = kernel_share(events, spans_of,
                                             trace.KERNELS).get(
                                                 kern, {}).get(label, 0.0)
            seen.update(out=out, spans=prog, checks=checks,
                        share=kernel_share(events, prog, trace.KERNELS))
            return out

    trace.DeviceTrace = ProgramSpanTrace
    result, details = run_cell(args.workload, args.seed, args.seconds, True)
    print(json.dumps(result))
    tr, share = seen["out"], seen["share"]
    idle_s = tr["window_s"] - tr["busy_s"]
    named_s = sum(s for _, s in tr["idle_gaps"])
    idle_metric = next((m["value"] for n, m in result["metrics"].items()
                        if n.startswith("device_idle_pct")), None)
    summary = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "correct": result["correct"], "completed": details["completed"],
        "window_s": tr["window_s"], "busy_s": tr["busy_s"],
        "idle_pct": 100.0 * idle_s / tr["window_s"],
        "device_idle_pct": idle_metric,
        "named_idle_pct": 100.0 * named_s / tr["window_s"],
        "idle_by_span": tr["idle_gaps"],
        "spans_in_window": Counter(n for n, _, _ in seen["spans"]),
        "kernel_share_by_span": share,
        "checks": seen["checks"],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
