"""bitmap_roofline_pct.<suffix>: the boundary-bitmap kernel's roofline
share, in %: the bytes the engine handed ``ops.boundary_bitmap`` in the
window (n bytes in, n flags out) over the H100's 3.35 TB/s, over the
device time of ``chunker_kernel`` in the trace."""

from bench.harness.trace import PEAK_BYTES_PER_S


def read(run):
    if run.trace is None or not run.kernel_bytes:
        return None
    t = run.trace["kernel_s"]["bitmap"]
    b = run.kernel_bytes["bitmap"]
    return 100.0 * b / PEAK_BYTES_PER_S / t if t and b else None
