"""device_idle_pct.<suffix>: the share of the traced window in which no
kernel, copy or set ran on the card, in %."""


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1 - run.trace["busy_s"] / run.trace["window_s"])
