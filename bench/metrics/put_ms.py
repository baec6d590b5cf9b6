"""put_ms.<suffix>: mean of the harness span "put" (the head's get, the
edits and ForkBase.put) in the window (ms)."""


def read(run):
    ms = run.span_ms("put")
    return sum(ms) / len(ms) if ms else None
