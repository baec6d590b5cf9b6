"""The traced run's instruments: a device trace of the window and a count of
the bytes the engine hands each kernel.

``DeviceTrace`` runs ``torch.profiler`` (device activity only) over the
measured window and reduces its events to the device's busy time (the
union of every kernel, copy and set on the card), the time of each kernel
by name, the device operations that took most time, and the idle gaps by
the harness span the host was in.  ``KernelBytes`` wraps the three entry
points of ``repro_torch.kernels.ops`` that launch kernels, from outside the
program, and counts each input byte once and each output byte once, from
the arguments alone: the count is the same whatever implements a kernel.
"""
from __future__ import annotations

import time
from collections import defaultdict

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
DIGEST_BYTES = 32

# kernel entry functions of src/repro_torch/kernels/csrc, by counted entry
KERNELS = {"hash": ("fphash_many_kernel", "fphash_host_kernel"),
           "bitmap": ("chunker_kernel",)}


class KernelBytes:
    """Bytes handed to the kernels through ``ops`` since the last
    ``reset``: ``hash`` (content_hash, content_hash_many: the strings in,
    32 bytes out each) and ``bitmap`` (boundary_bitmap: n bytes in, n
    flags out).  Install before the engine binds its hash functions."""

    def __init__(self):
        self.bytes = {"hash": 0, "bitmap": 0}
        self.counting = False

    def reset(self, counting: bool) -> None:
        self.bytes = dict.fromkeys(self.bytes, 0)
        self.counting = counting

    def install(self, ops) -> None:
        one, many, bitmap = (ops.content_hash, ops.content_hash_many,
                             ops.boundary_bitmap)

        def content_hash(data):
            if self.counting:
                self.bytes["hash"] += len(data) + DIGEST_BYTES
            return one(data)

        def content_hash_many(blobs):
            blobs = list(blobs)
            if self.counting:
                self.bytes["hash"] += (sum(map(len, blobs))
                                       + DIGEST_BYTES * len(blobs))
            return many(blobs)

        def boundary_bitmap(data, window=48, q=12):
            if self.counting:
                self.bytes["bitmap"] += 2 * len(data)
            return bitmap(data, window, q)

        self._saved = (one, many, bitmap)
        ops.content_hash = content_hash
        ops.content_hash_many = content_hash_many
        ops.boundary_bitmap = boundary_bitmap

    def uninstall(self, ops) -> None:
        (ops.content_hash, ops.content_hash_many,
         ops.boundary_bitmap) = self._saved


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(spans: list[tuple[str, int, int]], lo: int,
              hi: int) -> list[tuple[int, int, str]]:
    """[lo, hi) cut into pieces named by the innermost span covering each
    (spans nest, as one thread records them); uncovered pieces are named
    ``host``."""
    out: list[tuple[int, int, str]] = []
    cur = lo

    def emit(end: int, name: str) -> None:
        nonlocal cur
        end = min(max(end, lo), hi)
        if end > cur:
            out.append((cur, end, name))
            cur = end

    stack: list[tuple[str, int, int]] = []
    for name, s, e in sorted(spans, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= s:
            emit(stack[-1][2], stack.pop()[0])
        emit(s, stack[-1][0] if stack else "host")
        stack.append((name, s, e))
    while stack:
        emit(stack[-1][2], stack.pop()[0])
    emit(hi, "host")
    return out


class DeviceTrace:
    """torch.profiler over one window, device activity only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self, start_ns: int, end_ns: int,
             spans: list[tuple[str, int, int]]) -> dict:
        """Reduce the events inside [start_ns, end_ns) (wall-clock ns)."""
        import torch
        torch.cuda.synchronize()
        self.prof.stop()
        t = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        by_name: dict[str, float] = defaultdict(float)
        intervals = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != cuda:
                continue
            a = ev.start_ns()
            b = a + ev.duration_ns()
            a, b = max(a, start_ns), min(b, end_ns)
            if b <= a:
                continue
            intervals.append((a, b))
            by_name[ev.name()] += (b - a) / 1e9
        busy = _merge(intervals)
        busy_s = sum(b - a for a, b in busy) / 1e9
        idle: dict[str, float] = defaultdict(float)
        pieces = innermost(spans, start_ns, end_ns)
        gaps, cur = [], start_ns
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if end_ns > cur:
            gaps.append((cur, end_ns))
        i = 0
        for a, b in gaps:                   # both lists are in time order
            while i < len(pieces) and pieces[i][1] <= a:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < b:
                lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
                idle[pieces[j][2]] += (hi - lo) / 1e9
                j += 1
        kernel_s = {what: sum(s for n, s in by_name.items()
                              if any(k in n for k in names))
                    for what, names in KERNELS.items()}

        def top(d):                         # names cut to 160 characters
            return [[n[:160], s] for n, s in
                    sorted(d.items(), key=lambda x: -x[1])[:10]]
        return {"busy_s": busy_s, "window_s": (end_ns - start_ns) / 1e9,
                "events": len(intervals), "kernel_s": kernel_s,
                "device_ops": top(by_name), "idle_gaps": top(idle),
                "reduce_s": time.perf_counter() - t}
