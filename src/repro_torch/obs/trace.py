"""Span tracing with contextvar propagation, on one clock, into one ring.

``trace(name, **attrs)`` is a context manager.  Spans link to the
current span via a :mod:`contextvars` variable, so one client operation
(``Cluster.put`` → servlet → ``ForkBase`` → tiered → segment) yields a
single parent span whose children record per-layer durations and
chunk/byte counts — the paper's "where does a Put spend its time"
question answered from one ``with`` block at the call site.

Clock: a span's ``start_ns``/``end_ns`` are integer ns of
``time.perf_counter_ns`` (:func:`now_ns`, CLOCK_MONOTONIC on Linux), the
clock of event ``mono_us`` and snapshot ``now_us`` too.  :func:`unix_ns`
maps it onto the Unix clock that ``time.time_ns`` and ``torch.profiler``'s
device events use, by one offset taken at import from the tightest of
several paired reads; on Linux both clocks are slewed together, so the
offset holds unless the wall clock is stepped.

Record: every finished span goes into :data:`SPANS`, one bounded ring in
finish order.  When it is full the oldest span is dropped, counted in
``spans_dropped_total``, and ``SPANS.dropped_end_ns`` remembers how late
the newest dropped span ended, so a reader of a window can tell whether
the ring still holds all of it.  Spans finish on any thread, so the ring
takes a lock to add and hands its readers copies.  A span also keeps its
finished children (at most ``MAX_CHILDREN``), so :func:`recent_spans`'s
roots can be walked as trees.

When the registry is disabled, ``trace()`` returns a shared null
context manager: the whole cost is one attribute check plus a kwargs
dict, which is what keeps the disabled-mode overhead under the CI gate.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque

from .metrics import REGISTRY

__all__ = ["SPANS", "Span", "SpanRing", "current_span", "monotonic",
           "now_ns", "recent_spans", "trace", "unix_ns"]

#: Monotonic timer helper (satellite: replaces wall-clock ``time.time()``
#: deltas — immune to clock steps, so timings can't go negative).
monotonic = time.perf_counter
#: The span clock: integer ns on the same clock as ``monotonic``.
now_ns = time.perf_counter_ns


def _unix_offset_ns(pairs: int = 16) -> int:
    """``time_ns() - perf_counter_ns()`` from the pair read closest
    together (a wall read between two span-clock reads)."""
    best = None
    for _ in range(pairs):
        a = now_ns()
        # the span clock's one wall-clock read: the offset lays spans on
        # the Unix clock of torch.profiler's device events; nothing orders
        # or times by it
        w = time.time_ns()
        b = now_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


UNIX_OFFSET_NS = _unix_offset_ns()


def unix_ns(t_ns: int) -> int:
    """Span-clock ns (``now_ns``, ``Span.start_ns``) on the Unix clock."""
    return t_ns + UNIX_OFFSET_NS


_ids = itertools.count(1)
_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "repro_obs_span", default=None)

MAX_CHILDREN = 128
#: Ring size: a 51 s window of the benchmark's commit cell finishes
#: ~7,000 spans (about 15 a commit, ~470 commits), one of its read cell a
#: few hundred (2 a whole read); a span reader finds nothing once the ring
#: has dropped a span of its window.
SPAN_RING = 1 << 14


class Span:
    """One timed region, ``[start_ns, end_ns)`` on the span clock.
    ``children`` holds nested finished spans (bounded — overflow counts
    into ``dropped_children`` rather than growing without limit); every
    finished span, child or root, is also in :data:`SPANS`."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_ns",
                 "end_ns", "children", "dropped_children", "error")

    def __init__(self, name: str, attrs: dict, parent: Span | None):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        self.start_ns = 0
        self.end_ns = 0
        self.children: list[Span] = []
        self.dropped_children = 0
        self.error = ""

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _adopt(self, child: Span) -> None:
        if len(self.children) < MAX_CHILDREN:
            self.children.append(child)
        else:
            self.dropped_children += 1

    def child_seconds(self) -> float:
        return sum(c.duration_s for c in self.children)

    def walk(self):
        """Yield this span and every descendant, depth-first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def as_dict(self) -> dict:
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            # same clock as event ``mono_us``, so exported span trees and
            # the event journal line up on one timeline
            "start_us": self.start_ns / 1e3,
            "us": (self.end_ns - self.start_ns) / 1e3,
            "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
            "children": [c.as_dict() for c in self.children],
        }
        if self.error:
            d["error"] = self.error
        if self.dropped_children:
            d["dropped_children"] = self.dropped_children
        return d

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, us={self.duration_s * 1e6:.1f})")


class SpanRing:
    """Every finished span, oldest first, at most ``capacity``."""

    def __init__(self, capacity: int = SPAN_RING):
        self._ring: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        #: the latest end of a span the ring dropped (span clock), 0 if none
        self.dropped_end_ns = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def add(self, sp: Span) -> None:
        with self._lock:
            ring = self._ring
            full = len(ring) == ring.maxlen
            if full:
                self.dropped_end_ns = max(self.dropped_end_ns, ring[0].end_ns)
            ring.append(sp)
        if full and REGISTRY.enabled:
            REGISTRY.counter("spans_dropped_total").inc()

    def spans(self) -> list[Span]:
        """The finished spans, in the order they finished (a copy)."""
        with self._lock:
            return list(self._ring)

    def finished_since(self, t_ns: int) -> list[Span]:
        """The newest spans, newest first, back to the first one that
        ended at or before ``t_ns`` (span clock)."""
        out = []
        with self._lock:
            for sp in reversed(self._ring):
                if sp.end_ns <= t_ns:
                    break
                out.append(sp)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped_end_ns = 0

    def __len__(self) -> int:
        return len(self._ring)


#: The process-wide ring of finished spans.
SPANS = SpanRing()


def _jsonable(v):
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v).hex()
    if isinstance(v, (set, frozenset)):
        return sorted(_jsonable(x) for x in v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class _NullTrace:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_NULL = _NullTrace()


class _Trace:
    __slots__ = ("_name", "_attrs", "_hist", "_span", "_parent", "_token")

    def __init__(self, name, attrs, hist):
        self._name = name
        self._attrs = attrs
        self._hist = hist
        self._span = None
        self._parent = None
        self._token = None

    def __enter__(self) -> Span:
        self._parent = _current.get()
        sp = Span(self._name, self._attrs, self._parent)
        self._span = sp
        self._token = _current.set(sp)
        sp.start_ns = now_ns()
        return sp

    def __exit__(self, et, ev, tb):
        sp = self._span
        sp.end_ns = now_ns()
        _current.reset(self._token)
        if et is not None:
            sp.error = et.__name__
        if self._parent is not None:
            self._parent._adopt(sp)
        SPANS.add(sp)
        if self._hist is not None:
            self._hist.observe(sp.duration_s)
        return False


def trace(name: str, _hist=None, **attrs):
    """Open a span named ``name``.  Yields the :class:`Span` (or ``None``
    when observability is disabled).  ``_hist``: optional Histogram that
    receives the span duration on exit."""
    if not REGISTRY.enabled:
        return _NULL
    return _Trace(name, attrs, _hist)


def current_span() -> Span | None:
    return _current.get()


def recent_spans() -> list[Span]:
    """Root spans still in the ring, oldest first."""
    return [sp for sp in SPANS.spans() if sp.parent_id == 0]


def clear_recent_spans() -> None:
    SPANS.clear()
