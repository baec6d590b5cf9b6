"""block_commit_ms_p50.<suffix>: median of the harness span
"block.commit" (ForkBaseLedger.commit) in the window (ms)."""

import statistics


def read(run):
    ms = run.span_ms("block.commit")
    return statistics.median(ms) if ms else None
