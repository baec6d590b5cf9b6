"""commit_ms: the window's length over the commits it completed (ms)."""


def read(run):
    w = run.window
    return w.elapsed_s / w.completed * 1e3 if w.completed else None
