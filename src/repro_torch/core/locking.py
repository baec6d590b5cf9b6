"""Canonical lock order + runtime lock witness.

This module is the single source of truth for the engine's locking
contract (documented in the modules that take the locks, machine-readable
here).  The port keeps the reference's tables unchanged, so the static
analyzer resolves its ``with obj.<attr>:`` acquisitions the same way:

    servlet  ≺  collector  ≺  {index, store}  ≺  fence

* **servlet** (``Node.lock``) — per-servlet mutual exclusion around any
  touch of that node's ForkBase (branch table, live tables, pins).
  Servlet locks of *different* nodes may nest only in ascending node
  order, and only by ``Cluster.incremental_gc`` (every other verb takes
  at most one at a time).
* **collector** (``IncrementalCollector._collector_lock``, parked on
  stores as ``_barrier_lock`` while a collection is in flight) —
  serializes barrier/gray/condemned state between mutators and GC
  slices.
* **index** (``Cluster._index_lock``) — the master chunk-location map
  and quarantine/re-replication state.  Innermost alongside **store**;
  the two are *incomparable*: neither may be acquired while the other
  is held.
* **store** (``Node.store_lock``) — cross-thread access to one node's
  chunk store.  Never held across a listener callback.
* **fence** (``EpochFence._fence_lock``) — pin bookkeeping; a true
  leaf, never held across ``heads_fn`` (which takes servlet locks).

``LOCK_ORDER`` maps rank name -> numeric rank (lower = acquired
first/outermost); ``LOCK_ATTRS`` maps the attribute name each ranked
lock lives under -> its rank name.  The static analyzer
(the repository's analysis gate, rule LOCK001) consumes both tables; keep attribute
names unique repo-wide so a ``with obj.<attr>:`` acquisition resolves
without type inference.

The **runtime lock witness** (``REPRO_LOCK_WITNESS=1``, or
:func:`enable_witness` before constructing the cluster) swaps every
ranked lock for an instrumented wrapper that records the
acquired-before graph across threads, flags rank inversions and graph
cycles the moment the offending acquisition happens, and accounts
held-lock wall time per rank.  The scheduled runtime-race CI job runs
the threaded harness under it, turning the stress suite into a
race/deadlock detector.
"""
from __future__ import annotations

import itertools
import os
import threading
from dataclasses import dataclass, field
from time import perf_counter as _perf

from ..errors import ConfigError, InvariantViolation

__all__ = [
    "LOCK_ORDER", "LOCK_ATTRS", "make_lock", "WitnessLock",
    "LockWitness", "WITNESS", "enable_witness", "disable_witness",
    "witness_enabled",
]

#: Rank name -> numeric rank.  Lower rank = outermost (acquired first).
#: Equal ranks are incomparable: such locks must never nest (the
#: witness catches AB/BA cycles among them; LOCK001 flags lexical
#: nesting statically).
LOCK_ORDER: dict[str, int] = {
    "servlet": 10,
    "collector": 20,
    "index": 30,
    "store": 30,
    "fence": 40,
}

#: Attribute name -> rank name, for every ranked lock in the tree.
#: LOCK001 resolves a ``with <expr>.<attr>:`` acquisition through this
#: table, so these names are deliberately unique: unranked utility
#: locks (queue mutexes, admission, metrics) use other names.
LOCK_ATTRS: dict[str, str] = {
    "lock": "servlet",               # core.cluster.Node.lock
    "store_lock": "store",           # core.cluster.Node.store_lock
    "_index_lock": "index",          # core.cluster.Cluster._index_lock
    "_collector_lock": "collector",  # gc.incremental.IncrementalCollector
    "_barrier_lock": "collector",    # the collector lock parked on stores
    "_fence_lock": "fence",          # gc.incremental.EpochFence
}


_ENV_FLAG = os.environ.get("REPRO_LOCK_WITNESS", "")
_enabled = _ENV_FLAG not in ("", "0", "false", "no")


def witness_enabled() -> bool:
    return _enabled


def enable_witness() -> None:
    """Turn the witness on for locks created *after* this call (tests
    call it before constructing the cluster; CI sets the env var)."""
    global _enabled
    _enabled = True


def disable_witness() -> None:
    global _enabled
    _enabled = False


@dataclass
class LockViolation:
    """One detected ordering violation, recorded at acquisition time."""
    kind: str          # "rank-inversion" | "cycle"
    thread: str
    acquiring: str     # display name of the lock being acquired
    held: tuple        # display names of locks already held (outer first)
    detail: str = ""

    def __str__(self) -> str:
        return (f"{self.kind}: thread {self.thread!r} acquired "
                f"{self.acquiring} while holding {list(self.held)}"
                + (f" ({self.detail})" if self.detail else ""))


@dataclass
class HoldStats:
    acquisitions: int = 0
    held_total_s: float = 0.0
    held_max_s: float = 0.0


class LockWitness:
    """Acquired-before recorder shared by a set of :class:`WitnessLock`
    instances.  Detection happens inline at acquisition:

    * **rank inversion** — acquiring a lock of strictly LOWER rank than
      one already held by this thread (store -> servlet, collector ->
      servlet, ...) violates the documented order outright.
    * **cycle** — the acquisition adds held->new edges to the global
      acquired-before graph; if the new lock can already reach a held
      lock, two threads have (at some point) acquired the pair in
      opposite orders — a latent deadlock, even if this run got lucky.
      This is what catches same-rank pairs ({index, store}, two servlet
      locks out of ascending order), which rank comparison alone cannot.
      Graph nodes are per-lock monotonic tokens, NOT ``id()`` — CPython
      reuses freed addresses, so id-keyed edges from a dead lock would
      alias a newly created one and report false cycles.

    Violations are recorded, not raised (raising mid-critical-section in
    an arbitrary worker thread would wedge the harness); the test
    fixture asserts :meth:`assert_clean` after each test.  Held-lock
    wall time is accounted per display name on release."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tl = threading.local()
        self._edges: dict[int, set[int]] = {}
        self._names: dict[int, str] = {}
        self.violations: list[LockViolation] = []
        self.holds: dict[str, HoldStats] = {}

    # ------------------------------------------------------------ state
    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._names.clear()
            self.violations = []
            self.holds = {}

    def _held(self) -> list:
        held = getattr(self._tl, "held", None)
        if held is None:
            held = self._tl.held = []
        return held

    def _reaches(self, src: int, targets: set[int]) -> bool:
        """DFS over the acquired-before graph (caller holds _mu)."""
        seen = {src}
        stack = [src]
        while stack:
            for nxt in self._edges.get(stack.pop(), ()):
                if nxt in targets:
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    # ------------------------------------------------------ lock events
    def on_acquire(self, lock: "WitnessLock") -> None:
        held = self._held()
        if held:
            tname = threading.current_thread().name
            held_names = tuple(lk.display for lk in held)
            for outer in held:
                if lock.rank < outer.rank:
                    with self._mu:
                        self.violations.append(LockViolation(
                            "rank-inversion", tname, lock.display,
                            held_names,
                            f"{lock.rank_name}(rank {lock.rank}) under "
                            f"{outer.rank_name}(rank {outer.rank})"))
                    break
            with self._mu:
                self._names[lock.token] = lock.display
                targets = set()
                for outer in held:
                    if outer is lock:
                        continue
                    self._names[outer.token] = outer.display
                    targets.add(outer.token)
                if targets and self._reaches(lock.token, targets):
                    self.violations.append(LockViolation(
                        "cycle", tname, lock.display, held_names,
                        "acquired-before graph closed a cycle"))
                for t in targets:
                    self._edges.setdefault(t, set()).add(lock.token)
        held.append(lock)

    def on_release(self, lock: "WitnessLock", held_s: float) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                break
        with self._mu:
            st = self.holds.setdefault(lock.display, HoldStats())
            st.acquisitions += 1
            st.held_total_s += held_s
            st.held_max_s = max(st.held_max_s, held_s)

    # ---------------------------------------------------------- reports
    def report(self) -> dict:
        """JSON-safe summary: violations + held-lock wall time."""
        with self._mu:
            return {
                "violations": [str(v) for v in self.violations],
                "locks": {name: {"acquisitions": st.acquisitions,
                                 "held_total_s": st.held_total_s,
                                 "held_max_s": st.held_max_s}
                          for name, st in sorted(self.holds.items())},
            }

    def assert_clean(self) -> None:
        if self.violations:
            raise InvariantViolation(
                "lock witness recorded ordering violations:\n  "
                + "\n  ".join(str(v) for v in self.violations))


#: Process-wide witness every ``make_lock`` wrapper reports into.
WITNESS = LockWitness()


#: Graph-node tokens: unique for the process lifetime (never reused,
#: unlike ``id()``), so edges recorded for a dead lock can never alias a
#: new one.
_TOKENS = itertools.count(1)


class WitnessLock:
    """Instrumented re-entrant lock: a ``threading.RLock`` whose FIRST
    acquisition/final release per thread reports to a
    :class:`LockWitness`.  Context-manager and acquire/release
    compatible with RLock (nested re-entry is depth-counted and not
    re-reported)."""

    def __init__(self, rank_name: str, *, label: str = "",
                 witness: LockWitness | None = None):
        if rank_name not in LOCK_ORDER:
            raise ConfigError(
                f"unranked lock name {rank_name!r}; add it to "
                f"core.locking.LOCK_ORDER first")
        self.rank_name = rank_name
        self.rank = LOCK_ORDER[rank_name]
        self.label = label
        self.token = next(_TOKENS)
        self.display = (f"{rank_name}[{label}]" if label
                        else f"{rank_name}#{self.token}")
        self.witness = witness if witness is not None else WITNESS
        self._inner = threading.RLock()
        self._tl = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            depth = getattr(self._tl, "depth", 0)
            if depth == 0:
                self._tl.t0 = _perf()
                self.witness.on_acquire(self)
            self._tl.depth = depth + 1
        return got

    def release(self) -> None:
        depth = getattr(self._tl, "depth", 0)
        if depth == 1:
            self.witness.on_release(self, _perf() - self._tl.t0)
        self._tl.depth = depth - 1
        self._inner.release()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug sugar
        return f"<WitnessLock {self.display}>"


def make_lock(rank_name: str, *, label: str = ""):
    """The one factory ranked locks are created through.  Plain
    ``threading.RLock`` when the witness is off (zero overhead — the
    default), a :class:`WitnessLock` reporting into the global
    :data:`WITNESS` when on."""
    if _enabled:
        return WitnessLock(rank_name, label=label)
    if rank_name not in LOCK_ORDER:
        raise ConfigError(
            f"unranked lock name {rank_name!r}; add it to "
            f"core.locking.LOCK_ORDER first")
    return threading.RLock()
