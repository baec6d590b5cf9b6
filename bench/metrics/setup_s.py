"""setup_s: process start to the first timed operation (s)."""


def read(run):
    return run.setup_s
