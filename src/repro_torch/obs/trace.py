"""Span tracing with contextvar propagation.

``trace(name, **attrs)`` is a context manager.  Spans link to the
current span via a :mod:`contextvars` variable, so one client operation
(``Cluster.put`` → servlet → ``ForkBase`` → tiered → segment) yields a
single parent span whose children record per-layer durations and
chunk/byte counts — the paper's "where does a Put spend its time"
question answered from one ``with`` block at the call site.

When the registry is disabled, ``trace()`` returns a shared null
context manager: the whole cost is one attribute check plus a kwargs
dict, which is what keeps the disabled-mode overhead under the CI gate.
"""
from __future__ import annotations

import contextvars
import itertools
import time
from collections import deque

from .metrics import REGISTRY

__all__ = ["Span", "trace", "current_span", "recent_spans", "monotonic"]

#: Monotonic timer helper (satellite: replaces wall-clock ``time.time()``
#: deltas — immune to clock steps, so timings can't go negative).
monotonic = time.perf_counter

_ids = itertools.count(1)
_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "repro_obs_span", default=None)
# Finished spans with no parent land here so exporters can show recent
# operation trees without anyone holding a reference.
_recent_roots: deque[Span] = deque(maxlen=32)

MAX_CHILDREN = 128


class Span:
    """One timed region.  ``duration_s`` is set on exit; ``children``
    holds nested finished spans (bounded — overflow counts into
    ``dropped_children`` rather than growing without limit)."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_s",
                 "duration_s", "children", "dropped_children", "error")

    def __init__(self, name: str, attrs: dict, parent: Span | None):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        self.start_s = 0.0
        self.duration_s = 0.0
        self.children: list[Span] = []
        self.dropped_children = 0
        self.error = ""

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
            "start_us": round(self.start_s * 1e6, 3),
            "us": round(self.duration_s * 1e6, 3),
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
        sp.start_s = monotonic()
        return sp

    def __exit__(self, et, ev, tb):
        sp = self._span
        sp.duration_s = monotonic() - sp.start_s
        _current.reset(self._token)
        if et is not None:
            sp.error = et.__name__
        parent = self._parent
        if parent is not None:
            parent._adopt(sp)
        else:
            _recent_roots.append(sp)
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
    """Recently finished root spans, oldest first."""
    return list(_recent_roots)


def clear_recent_spans() -> None:
    _recent_roots.clear()
