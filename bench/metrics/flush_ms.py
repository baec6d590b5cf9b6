"""flush_ms.<suffix>: the program's ``buffer.flush`` spans
(``WriteBuffer.flush``: a value's batch into the store's ``put_many``,
with the store's put checks and the memory tier's demotions) in the
window, in ms an operation completed (``splice_ms.window_spans``)."""

from bench.metrics.splice_ms import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "buffer.flush")
