"""checkout_MBps: bytes of versions read back over the window (MB/s)."""


def read(run):
    w = run.window
    return w.units / w.elapsed_s / 1e6 if w.completed else None
