"""gather_ms.<suffix>: the program's ``splice.gather`` spans (the
splice's reads of the old leaves, each checked against its cid, and of
the warm-up bytes) in the window, in ms an operation completed
(``splice_ms.window_spans``)."""

from bench.metrics.splice_ms import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "splice.gather")
