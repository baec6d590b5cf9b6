"""Bounded structured event journal.

Lifecycle events — GC phase transitions, epoch folds, segment
compactions, tier demotions/promotions, audit findings and
quarantine/release, torn-tail truncations on reopen — land here as
small dicts in a ring buffer, optionally teed to a JSONL sink.  Every
emit also bumps the ``events_total{kind=...}`` counter in the registry
so event *rates* survive after the ring has wrapped.
"""
from __future__ import annotations

import json
import time
from collections import Counter as _TallyCounter
from collections import deque

from .metrics import REGISTRY
from .trace import _jsonable, monotonic

__all__ = ["EventLog", "EVENTS", "emit"]


class EventLog:
    """Ring buffer of structured events plus an optional JSONL sink."""

    def __init__(self, capacity: int = 1024, sink_path: str | None = None,
                 registry=None):
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._counts: _TallyCounter[str] = _TallyCounter()
        self._sink = None
        self._reg = registry if registry is not None else REGISTRY
        if sink_path:
            self.open_sink(sink_path)

    def open_sink(self, path: str) -> None:
        self.close_sink()
        self._sink = open(path, "a", encoding="utf-8")

    def close_sink(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def emit(self, kind: str, **attrs) -> None:
        if not self._reg.enabled:
            return
        # ``ts`` (wall clock) is for the JSONL sink and humans; ``mono_us``
        # shares the span clock (trace.monotonic), so events and span
        # timelines correlate — snapshot() exports the same clock's "now"
        # repro: allow(CONTRACT002): journal timestamps are wall-clock on
        # purpose so external logs can be correlated; ordering never uses
        # ts — it uses mono_us from the span clock
        ev = {"kind": kind, "ts": round(time.time(), 6),
              "mono_us": round(monotonic() * 1e6, 3)}
        for k, v in attrs.items():
            ev[k] = _jsonable(v)
        self._ring.append(ev)
        self._counts[kind] += 1
        self._reg.counter("events_total", {"kind": kind}).inc()
        if self._sink is not None:
            self._sink.write(json.dumps(ev, sort_keys=True) + "\n")
            self._sink.flush()

    def events(self, kind: str | None = None, limit: int = 0) -> list[dict]:
        out = [e for e in self._ring if kind is None or e["kind"] == kind]
        return out[-limit:] if limit else out

    def counts(self) -> dict[str, int]:
        return dict(self._counts)

    def clear(self) -> None:
        self._ring.clear()
        self._counts.clear()

    def __len__(self) -> int:
        return len(self._ring)


#: Process-wide journal — subsystems emit here via :func:`emit`.
EVENTS = EventLog()


def emit(kind: str, **attrs) -> None:
    """Emit a structured event into the global journal (no-op when
    observability is disabled)."""
    EVENTS.emit(kind, **attrs)
