"""Exporters: JSON snapshot and Prometheus-style text dump.

``snapshot()`` merges the metrics registry (with histogram
percentiles), the event journal, GC report/pause history, recent span
trees, and any ``StoreStats`` the caller passes — pulled at snapshot
time, never pushed into registry counters, so a backend reopen that
*replays* its persisted stats can never double-count here.
"""
from __future__ import annotations

from .events import EVENTS
from .metrics import REGISTRY, Counter, Gauge
from .trace import monotonic, recent_spans

__all__ = ["snapshot", "prometheus_text"]


def snapshot(stores=None, extra=None, *, events_limit: int = 256) -> dict:
    """JSON-safe observability snapshot.

    ``stores``: optional mapping of name → object with ``as_dict()``
    (``StoreStats``).  ``extra``: dict merged into the top level
    (subsystem verbs like ``ForkBase.observe`` use it).
    """
    out = {
        "enabled": REGISTRY.enabled,
        # monotonic reference point (same clock as event ``mono_us`` and
        # span ``start_us``): consumers compute event/span ages against
        # this instead of wall time, immune to clock steps
        "now_us": round(monotonic() * 1e6, 3),
        "metrics": REGISTRY.as_dict(),
        "events": EVENTS.events(limit=events_limit),
        "event_counts": EVENTS.counts(),
        "gc": {
            "reports": list(REGISTRY.gc_reports),
            "slice_pauses": list(REGISTRY.gc_pauses),
        },
        "spans": [sp.as_dict() for sp in recent_spans()],
    }
    if stores:
        out["stores"] = {name: st.as_dict() for name, st in stores.items()}
    if extra:
        for k, v in extra.items():
            out[k] = v
    return out


def prometheus_text(stores=None) -> str:
    """Prometheus exposition-style dump of every registered instrument
    (plus optional ``StoreStats`` rendered as gauges)."""
    lines: list[str] = []
    seen_types: set[str] = set()

    def _type(name: str, kind: str) -> None:
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, inst in REGISTRY.instruments():
        if isinstance(inst, Counter):
            _type(inst.name, "counter")
            lines.append(f"{key} {inst.value}")
        elif isinstance(inst, Gauge):
            _type(inst.name, "gauge")
            lines.append(f"{key} {inst.value}")
        else:  # Histogram -> summary-style quantiles
            _type(inst.name, "summary")
            base, brace, rest = key.partition("{")
            inner = rest[:-1] if brace else ""

            def q(quantile, value, _inner=inner, _base=base):
                lab = (f"{_inner},quantile=\"{quantile}\"" if _inner
                       else f"quantile=\"{quantile}\"")
                lines.append(f"{_base}{{{lab}}} {value}")

            q("0.5", inst.p50)
            q("0.99", inst.p99)
            q("1", inst.max_us)
            lines.append(f"{base}_count{'{' + inner + '}' if inner else ''} "
                         f"{inst.count}")
            lines.append(f"{base}_sum{'{' + inner + '}' if inner else ''} "
                         f"{round(inst.sum_us, 3)}")
    if stores:
        for sname, st in sorted(stores.items()):
            for field, v in st.as_dict().items():
                name = f"store_{field}"
                _type(name, "gauge")
                lines.append(f'{name}{{store="{sname}"}} {v}')
    return "\n".join(lines) + "\n"
