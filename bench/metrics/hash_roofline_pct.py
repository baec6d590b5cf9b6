"""hash_roofline_pct.<suffix>: the fphash kernels' roofline share, in %:
the bytes the engine handed ``ops.content_hash`` and
``ops.content_hash_many`` in the window (each input byte once, 32 bytes
out a string) over the H100's 3.35 TB/s, over the device time of
``fphash_many_kernel`` and ``fphash_host_kernel`` in the trace."""

from bench.harness.trace import PEAK_BYTES_PER_S


def read(run):
    if run.trace is None or not run.kernel_bytes:
        return None
    t = run.trace["kernel_s"]["hash"]
    b = run.kernel_bytes["hash"]
    return 100.0 * b / PEAK_BYTES_PER_S / t if t and b else None
