"""ledger_tx_per_s: transactions (reads and writes) of the blocks
committed in the window, over the window."""


def read(run):
    w = run.window
    return w.units / w.elapsed_s if w.completed else None
