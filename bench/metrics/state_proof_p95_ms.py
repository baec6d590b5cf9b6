"""state_proof_p95_ms: 95th percentile of every query's prove plus verify
in the window (ms)."""

from bench.harness.core import quantile


def read(run):
    lat = run.window.latencies_s
    return quantile(lat, 0.95) * 1e3 if lat else None
