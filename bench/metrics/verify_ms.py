"""verify_ms.<suffix>: median of the harness span "verify"
(LightClient.verify_state_flat) in the window (ms)."""

import statistics


def read(run):
    ms = run.span_ms("verify")
    return statistics.median(ms) if ms else None
