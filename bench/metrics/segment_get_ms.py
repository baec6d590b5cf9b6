"""segment_get_ms.<suffix>: the program's ``segment.get`` spans
(``SegmentBackend``'s read of one batch from the segment files: a copy
out of the file and a check a chunk) in the window, in ms an operation
completed (``splice_ms.window_spans``).  Nothing is read where the
program records no such span, or where the span ring dropped part of the
window."""

from bench.metrics.splice_ms import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "segment.get")
