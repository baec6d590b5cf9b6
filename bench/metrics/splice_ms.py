"""splice_ms.<suffix>: the program's ``tree.splice`` spans
(``POSTree.splice_bytes``: gather, apply, chunk, encode, index) in the
window, in ms an operation completed.

The program's spans are read from ``repro_torch.obs``'s ring of finished
spans and laid on the window's Unix clock with ``obs.unix_ns``; a span
counts when it starts inside the window.  Nothing is read where the
program keeps no such ring, or where the ring dropped a span that ended
inside the window or later."""


def window_spans(run, name: str):
    """The program's finished spans ``name`` that start inside the
    window, or None when the ring cannot tell."""
    try:
        from repro_torch import obs
        ring, unix_ns = obs.SPANS, obs.unix_ns
    except (ImportError, AttributeError):
        return None
    lo = run.window.start_ns
    hi = lo + int(run.window.elapsed_s * 1e9)
    if ring.dropped_end_ns and unix_ns(ring.dropped_end_ns) >= lo:
        return None
    return [sp for sp in ring.spans()
            if sp.name == name and lo <= unix_ns(sp.start_ns) < hi]


def span_ms_per_op(run, name: str):
    """Milliseconds of the spans ``name`` in the window over the
    operations completed; None when there are none to read."""
    spans = window_spans(run, name)
    if not spans or not run.window.completed:
        return None
    return (sum(sp.end_ns - sp.start_ns for sp in spans) / 1e6
            / run.window.completed)


def read(run):
    return span_ms_per_op(run, "tree.splice")
