"""fold_ms.<suffix>: the live tier's fold time a block, from the program's
``live_fold_us`` histogram: its sum over the window over the blocks
committed (ms)."""


def read(run):
    folds = run.delta("live_folds")
    if not folds or not run.window.completed:
        return None
    return run.delta("live_fold_us") / 1e3 / run.window.completed
