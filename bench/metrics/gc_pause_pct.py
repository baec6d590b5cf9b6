"""gc_pause_pct.<suffix>: the share of the window in which CPython's cyclic
collector ran (every generation, timed by ``gc.callbacks``), in %."""


def read(run):
    if run.gc is None or not run.window.elapsed_s:
        return None
    return 100.0 * sum(run.gc.seconds) / run.window.elapsed_s
