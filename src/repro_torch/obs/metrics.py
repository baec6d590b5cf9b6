"""Process-wide metrics registry: counters, gauges, latency histograms.

Stdlib-only by design — the storage layer and every other subsystem can
import this module without creating an import cycle.  All instruments
hang off one :class:`MetricsRegistry` (the module singleton
``REGISTRY``); a single ``enabled`` flag turns every record path into a
cheap no-op, which is what the ``obs-overhead`` CI gate measures.

Histograms use fixed power-of-two microsecond buckets (bucket *i* holds
samples in ``[2**(i-1), 2**i) µs``), so ``observe()`` is one
``bit_length()`` call and an increment — no allocation, no deps — while
still answering p50/p99/max questions well enough for pause and
latency attribution.
"""
from __future__ import annotations

import os
import threading
from collections import deque

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
]

# 40 buckets cover [1 µs, 2**39 µs ~= 6.4 days) — anything slower
# saturates the last bucket rather than raising.
_NBUCKETS = 40


def _render_key(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "labels", "value", "_reg")

    def __init__(self, name, labels, reg):
        self.name = name
        self.labels = labels
        self.value = 0
        self._reg = reg

    def inc(self, n: int = 1) -> None:
        if self._reg.enabled:
            self.value += n

    def as_value(self):
        return self.value


class Gauge:
    """Last-write-wins scalar (ints or floats)."""

    __slots__ = ("name", "labels", "value", "_reg")

    def __init__(self, name, labels, reg):
        self.name = name
        self.labels = labels
        self.value = 0
        self._reg = reg

    def set(self, v) -> None:
        if self._reg.enabled:
            self.value = v

    def inc(self, n=1) -> None:
        if self._reg.enabled:
            self.value += n

    def dec(self, n=1) -> None:
        if self._reg.enabled:
            self.value -= n

    def as_value(self):
        return self.value


class Histogram:
    """Fixed power-of-two µs-bucket latency histogram.

    ``observe()`` takes *seconds* (what ``perf_counter`` deltas give
    you) and buckets in microseconds.  Percentiles are answered at the
    bucket upper bound — coarse (factor-of-two) but monotone, stable,
    and free of any per-sample storage.
    """

    __slots__ = ("name", "labels", "buckets", "count", "sum_us", "max_us",
                 "_reg")

    def __init__(self, name, labels, reg):
        self.name = name
        self.labels = labels
        self.buckets = [0] * _NBUCKETS
        self.count = 0
        self.sum_us = 0.0
        self.max_us = 0.0
        self._reg = reg

    def observe(self, seconds: float) -> None:
        if not self._reg.enabled:
            return
        us = seconds * 1e6
        i = int(us).bit_length()
        if i >= _NBUCKETS:
            i = _NBUCKETS - 1
        self.buckets[i] += 1
        self.count += 1
        self.sum_us += us
        if us > self.max_us:
            self.max_us = us

    def percentile(self, p: float) -> float:
        """Upper bucket bound (µs) below which fraction ``p`` of samples
        fall.  Returns 0.0 for an empty histogram."""
        if self.count == 0:
            return 0.0
        want = p * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= want:
                return float(1 << i)
        return float(1 << (_NBUCKETS - 1))

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.count if self.count else 0.0

    def as_value(self):
        return {
            "count": self.count,
            "sum_us": round(self.sum_us, 3),
            "mean_us": round(self.mean_us, 3),
            "p50_us": self.p50,
            "p99_us": self.p99,
            "max_us": round(self.max_us, 3),
        }


class MetricsRegistry:
    """Named instrument store plus the global enabled flag.

    ``counter/gauge/histogram`` are get-or-create: callers anywhere in
    the process that name the same instrument (and labels) share it.
    GC telemetry keeps bounded history here too — ``gc_reports`` holds
    recent ``GCReport`` dicts, ``gc_pauses`` the per-``step()`` pause
    samples — so ``obs.snapshot()`` can answer "how long are GC pauses
    really" without any subsystem retaining its own log.
    """

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_OBS", "1") not in ("0", "false")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self.gc_reports: deque[dict] = deque(maxlen=64)
        self.gc_pauses: deque[dict] = deque(maxlen=512)

    # ------------------------------------------------------ instruments
    def _get(self, cls, name: str, labels: dict | None):
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items())) \
            if labels else ()
        key = _render_key(name, lab)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, lab, self)
                    self._instruments[key] = inst
        if type(inst) is not cls:
            raise TypeError(f"{key} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: dict | None = None) -> Histogram:
        return self._get(Histogram, name, labels)

    # --------------------------------------------------------- switches
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop all instruments and history (tests, bench trials)."""
        with self._lock:
            self._instruments.clear()
            self.gc_reports.clear()
            self.gc_pauses.clear()

    # ----------------------------------------------------- gc telemetry
    def record_gc_report(self, report_dict: dict) -> None:
        if self.enabled:
            self.gc_reports.append(report_dict)

    def record_gc_pause(self, phase: str, seconds: float, *,
                        epoch: int = 0) -> None:
        if not self.enabled:
            return
        self.gc_pauses.append({"phase": phase, "epoch": epoch,
                               "us": round(seconds * 1e6, 3)})
        self.histogram("gc_slice_us").observe(seconds)

    # ----------------------------------------------------------- export
    def as_dict(self) -> dict:
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for key, inst in sorted(self._instruments.items()):
            if isinstance(inst, Counter):
                out["counters"][key] = inst.as_value()
            elif isinstance(inst, Gauge):
                out["gauges"][key] = inst.as_value()
            else:
                out["histograms"][key] = inst.as_value()
        return out

    def instruments(self):
        return sorted(self._instruments.items())


REGISTRY = MetricsRegistry()
