"""segment_check_ms.<suffix>: the time of the segment tier's own chunk
checks in the window (``StoreStats.verify_ns`` of ``db.store.cold``, which
a family's counters hold as ``"cold"``: each chunk read from a segment
file, and each chunk demoted to one, checked against its cid), in ms an
operation completed.  Nothing is read where the family holds no such
counters, or where checks ran untimed (observability off)."""


def read(run):
    cold = run.before.get("cold", {})
    if "verify_ns" not in cold or not run.window.completed:
        return None
    ns = run.delta("cold", "verify_ns")
    if not ns and run.delta("cold", "verifies"):
        return None
    return ns / 1e6 / run.window.completed
