"""check_ms.<suffix>: the time of the tiered store's chunk checks in the
window (``StoreStats.verify_ns`` of ``db.store``: each check of a chunk
against its cid at a put into the store or a get from it, timed where it
is counted), in ms an operation completed.  The segment tier's own
re-checks of the chunks demoted to it at a flush are counted in its own
``StoreStats``, which this metric does not read.  Nothing is read where
the program has no such counter, or where checks ran untimed
(observability off)."""


def read(run):
    store = run.before.get("store", {})
    if "verify_ns" not in store or not run.window.completed:
        return None
    ns = run.delta("store", "verify_ns")
    if not ns and run.delta("store", "verifies"):
        return None
    return ns / 1e6 / run.window.completed
