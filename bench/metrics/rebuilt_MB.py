"""rebuilt_MB.<suffix>: bytes the splice handed the boundary bitmap in
the window (the ``rechunked`` count of the program's ``tree.splice``
spans, over every attempt), in MB an operation completed
(``splice_ms.window_spans``)."""

from bench.metrics.splice_ms import window_spans


def read(run):
    spans = window_spans(run, "tree.splice")
    if not spans or not run.window.completed:
        return None
    return (sum(sp.attrs.get("rechunked", 0) for sp in spans) / 1e6
            / run.window.completed)
