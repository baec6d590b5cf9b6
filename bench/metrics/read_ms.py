"""read_ms.<suffix>: mean of the harness span "read" (ForkBase.get and the
whole version's read) in the window (ms)."""


def read(run):
    ms = run.span_ms("read")
    return sum(ms) / len(ms) if ms else None
