"""One run of one cell: set-up, the measured window, the judge, the metrics.

``run_cell`` is what ``bench/run.py`` calls on the card and what the tests
call on the CPU; it returns the result line's object and, apart, the
details that go on earlier lines.
"""
from __future__ import annotations

import gc
import os
import resource
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from . import core


@dataclass
class Run:
    """What a metric's reader reads: the window, the set-up time, the
    harness spans, the program's counters before and after the window
    and, in a traced run, the device trace and the bytes handed to the
    kernels; the collector's pauses in the window."""

    window: core.Window
    setup_s: float
    spans: core.Spans
    before: dict
    after: dict
    trace: dict | None = None
    kernel_bytes: dict | None = None
    gc: core.GCPauses | None = None

    def delta(self, *path) -> float:
        a, b = self.before, self.after
        for p in path:
            a, b = a[p], b[p]
        return b - a

    def span_ms(self, name: str) -> list[float]:
        """Milliseconds of each span ``name`` inside the window."""
        return [s * 1e3 for s in self.spans.durations(name,
                                                      self.window.start_ns)]


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             bench: dict | None = None, bench_dir: Path = core.BENCH_DIR,
             config: dict | None = None, traffic: dict | None = None,
             plant=None) -> tuple[dict, dict]:
    """Run cell ``name`` once.  ``config`` and ``traffic`` replace the
    cell's (the tests' small sizes); ``plant(family)``, called once the
    set-up is done, breaks the timed path underneath (the controls and
    the tests of the judge, ``bench/control.py``)."""
    import torch

    from repro_torch.kernels import ops

    t_start = time.perf_counter() if t_start is None else t_start
    bench = core.load_benchmark(bench_dir.parent) if bench is None else bench
    cell = core.cell_of(bench, name)
    config = core.load_config(cell["config"], bench_dir) if config is None \
        else config
    traffic = core.load_traffic(cell["traffic"], bench_dir) \
        if traffic is None else traffic
    cuda = device.startswith("cuda")
    ops.set_device(device)
    kbytes = None
    if trace:
        from .trace import KernelBytes
        kbytes = KernelBytes()
        kbytes.install(ops)
    power = _power_limit_w() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    family = core.family(config["family"], bench_dir)(config, traffic, seed)
    op = core.operation(traffic["op"], bench_dir)
    spans = core.Spans(trace)
    ops.reset_launches()
    family.setup(spans)
    op(family, spans)                       # warm every path it takes
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if plant is not None:
        plant(family)
    before = family.counters()
    tracer = None
    if trace:
        from .trace import DeviceTrace
        kbytes.reset(counting=True)
        if cuda:
            tracer = DeviceTrace()
            tracer.start()
    host0 = core.host_sample()
    use0, load0 = resource.getrusage(resource.RUSAGE_SELF), os.getloadavg()
    with core.GCPauses() as pauses:
        win = core.measure(op, family, seconds, spans)
    use1, load1 = resource.getrusage(resource.RUSAGE_SELF), os.getloadavg()
    host1 = core.host_sample()
    tr = None
    if tracer is not None:
        tr = tracer.stop(win.start_ns,
                         win.start_ns + int(win.elapsed_s * 1e9),
                         spans.records)
    if cuda:
        torch.cuda.synchronize()
    after = family.counters()
    if trace:
        kbytes.counting = False
        kbytes.uninstall(ops)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    t = time.perf_counter()
    family.finish()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = family.judge(device)
    checks["failed_ops"] = (win.failed, 0)
    judge_s = time.perf_counter() - t
    run = Run(win, setup_s, spans, before, after, tr,
              kbytes.bytes if kbytes else None, pauses)
    metrics = {}
    for m in core.metrics_of(bench, name, trace):
        value = core.reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": 1, "memory_peak_bytes": peak}
    if power is not None:
        dev["power_limit_w"] = power
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    correct = win.completed > 0 and all(v <= lim for v, lim in
                                        checks.values())
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    details = {"workload": name, "seed": seed, "seconds": seconds,
               "completed": win.completed, "elapsed_s": win.elapsed_s,
               "units": win.units, "errors": win.errors,
               "judge_s": judge_s,
               "planted": getattr(plant, "__name__", None),
               "gc": {"collections": pauses.count,
                      "seconds": pauses.seconds},
               "host": {"loadavg": [load0[0], load1[0]],
                        **{k: getattr(use1, k) - getattr(use0, k)
                           for k in ("ru_utime", "ru_stime", "ru_nvcsw",
                                     "ru_nivcsw", "ru_minflt")},
                        **core.host_delta(host0, host1)},
               "op_ms": [round(x * 1e3, 2) for x in win.op_s],
               "launches": {k: run.delta("launches", k)
                            for k in after["launches"]}}
    if trace:
        details["kernel_bytes"] = kbytes.bytes
    if tr is not None:
        details["trace"] = {k: tr[k] for k in ("events", "kernel_s",
                                                "reduce_s")}
    return result, details
