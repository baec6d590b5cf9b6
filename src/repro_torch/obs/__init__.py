"""Unified observability layer: metrics, spans, events, exporters.

Stdlib-only (no intra-package imports), so every subsystem — storage
backends included — can depend on it without cycles.  One process-wide
:data:`REGISTRY` holds all instruments; ``REPRO_OBS=0`` in the
environment starts the process disabled, and :func:`enable` /
:func:`disable` flip it at runtime.  Disabled mode reduces every
record path to a flag check (gated <10% overhead by the
``obs-overhead`` CI job).

Typical use::

    from repro_torch import obs

    with obs.trace("client.put", key=key) as sp:
        db.put(key, value)               # nested layer spans attach to sp
    obs.emit("myapp.thing", detail=42)
    snap = obs.snapshot(stores={"store": db.store.stats})
"""
from __future__ import annotations

from .events import EVENTS, EventLog, emit
from .export import prometheus_text, snapshot
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .trace import (Span, clear_recent_spans, current_span, monotonic,
                    recent_spans, trace)

__all__ = [
    "Counter",
    "EVENTS",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "Span",
    "clear_recent_spans",
    "counter",
    "current_span",
    "disable",
    "emit",
    "enable",
    "enabled",
    "gauge",
    "histogram",
    "inc",
    "monotonic",
    "observe",
    "prometheus_text",
    "recent_spans",
    "record_gc_pause",
    "record_gc_report",
    "reset",
    "set_gauge",
    "snapshot",
    "trace",
]


def enabled() -> bool:
    return REGISTRY.enabled


def enable() -> None:
    REGISTRY.enable()


def disable() -> None:
    REGISTRY.disable()


def reset() -> None:
    """Drop all instruments, events and span history (tests/benches)."""
    REGISTRY.reset()
    EVENTS.clear()
    clear_recent_spans()


def counter(name: str, labels: dict | None = None) -> Counter:
    # repro: allow(OBS001): handle factory for callers that memoize it; the obs package is the guard's own implementation
    return REGISTRY.counter(name, labels)


def gauge(name: str, labels: dict | None = None) -> Gauge:
    # repro: allow(OBS001): handle factory for callers that memoize it; the obs package is the guard's own implementation
    return REGISTRY.gauge(name, labels)


def histogram(name: str, labels: dict | None = None) -> Histogram:
    # repro: allow(OBS001): handle factory for callers that memoize it; the obs package is the guard's own implementation
    return REGISTRY.histogram(name, labels)


def inc(name: str, n: int = 1, labels: dict | None = None) -> None:
    """Bump a named counter (no-op when disabled)."""
    if REGISTRY.enabled:
        REGISTRY.counter(name, labels).inc(n)


def set_gauge(name: str, value, labels: dict | None = None) -> None:
    if REGISTRY.enabled:
        REGISTRY.gauge(name, labels).set(value)


def observe(name: str, seconds: float, labels: dict | None = None) -> None:
    """Record a duration into a named histogram (no-op when disabled)."""
    if REGISTRY.enabled:
        REGISTRY.histogram(name, labels).observe(seconds)


def record_gc_report(report) -> None:
    """File a ``GCReport`` (dataclass or dict) into bounded history."""
    if not REGISTRY.enabled:
        return
    if not isinstance(report, dict):
        import dataclasses
        report = dataclasses.asdict(report)
    REGISTRY.record_gc_report(report)


def record_gc_pause(phase: str, seconds: float, *, epoch: int = 0) -> None:
    REGISTRY.record_gc_pause(str(phase), seconds, epoch=epoch)
