"""prove_ms.<suffix>: median of the harness span "prove"
(ForkBaseLedger.prove_state_flat) in the window (ms)."""

import statistics


def read(run):
    ms = run.span_ms("prove")
    return statistics.median(ms) if ms else None
