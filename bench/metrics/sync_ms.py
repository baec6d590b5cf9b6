"""sync_ms.<suffix>: mean of the harness span "sync" (ForkBase.sync) in
the window (ms)."""


def read(run):
    ms = run.span_ms("sync")
    return sum(ms) / len(ms) if ms else None
