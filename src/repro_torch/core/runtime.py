"""Event-driven cluster runtime (paper §4.1's dispatcher, made real).

The synchronous ``Cluster`` verbs serve one request per call: every
client put is its own WriteBuffer flush, its own per-node ``put_many``
fan-out, its own branch-table update.  This module adds the runtime
the deployment section describes:

* **Coalesced dispatch** — concurrent client requests queue per home
  servlet and drain in cross-client batches through
  ``Cluster.put_batch`` / ``get_batch``: one WriteBuffer flush (one
  routing ``put_many`` per storage node) covers every request in the
  batch — the §4.6.1 WriteBuffer idea lifted from the chunk layer to
  the RPC layer.

* **Bounded queues with obs-driven admission** — each servlet queue is
  bounded; a full queue raises :class:`Backpressure` to the submitting
  client instead of buffering without limit.  Admission reads the same
  instruments ``obs.snapshot()`` exports: a windowed p99 over the
  routing store's ``store_put_us`` histogram (bucket-array diffs — no
  per-sample storage) plus the recent span tree (any fresh slow
  ``store.put``/``cluster.put`` root), and halves the effective queue
  bound and dispatch batch while the store is slow, shedding load
  early rather than at the deep end of the queue.

* **MaintenanceDaemon** — ONE time-paced loop sharing one per-tick
  budget across every background duty: re-replication of quarantined
  nodes' chunks, incremental-GC slices, continuous-audit ticks, epoch
  folds (staggered one servlet per fold tick, so no tick stalls every
  servlet), and store flush/compaction (also staggered).  The daemon
  backs off — quarters its budget — when the foreground is busy, as
  judged by the queue-depth gauges and put-rate counters that
  ``obs.snapshot()`` exposes.

Everything works in two modes: synchronous ``drain()`` on the caller's
thread (deterministic — what the tests use) and threaded
``start()``/``stop()`` with one dispatcher worker per servlet plus the
daemon thread.  Thread safety leans on the cluster's documented lock
order: servlet lock ≺ collector lock ≺ {index lock, store lock}
(canonical, machine-readable table: ``core.locking.LOCK_ORDER``;
the LOCK001 static rule and the runtime lock witness both enforce
it from that single source).
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

from .. import obs
from ..errors import Backpressure

__all__ = ["Backpressure", "RuntimeConfig", "ClusterRuntime",
           "MaintenanceDaemon"]


@dataclass
class RuntimeConfig:
    # admission / dispatch
    queue_depth: int = 256       # per-servlet bound (requests)
    max_batch: int = 64          # requests coalesced per dispatch
    admission_p99_us: float = 20_000.0   # windowed store-put p99 above
    #   which admission halves the queue bound and dispatch batch
    slow_span_us: float = 50_000.0       # a fresh root span this slow
    #   counts as a latency signal too (span-tree admission input)
    # maintenance daemon
    tick_interval_s: float = 0.005       # time pacing between ticks
    tick_budget: int = 128       # work units (chunks/targets) per tick
    backoff_queued: int = 32     # queued foreground requests ⇒ back off
    backoff_put_rate: int = 256  # foreground puts since last tick ⇒ idem
    fold_every: int = 4          # ticks between staggered epoch folds
    audit_every: int = 2         # ticks between audit ticks
    compact_every: int = 8       # ticks between staggered store flushes
    gc_cycle_ticks: int = 0      # >0: begin an incremental GC epoch
    #   every N ticks (0 = caller manages collections)


class _AdmissionController:
    """Windowed latency signal from instruments ``obs.snapshot()``
    exports.  ``store_put_us{backend=routing}`` is cumulative, so the
    window is the *diff* of its bucket array since the last decision;
    the span input scans the span ring (``obs.SPANS``) back from its
    newest span, on the span clock ``obs.now_ns``, to consider only spans
    that started since then.
    With observability disabled there are no samples and admission
    falls back to the static queue bound."""

    def __init__(self, cfg: RuntimeConfig):
        self.cfg = cfg
        # repro: allow(OBS001): once-per-runtime construction, not a hot
        # path — the histogram handle is cached and must exist even if
        # obs is enabled later mid-run
        self._hist = obs.REGISTRY.histogram("store_put_us",
                                            {"backend": "routing"})
        self._last_buckets = list(self._hist.buckets)
        self._last_ns = obs.now_ns()
        self._lock = threading.Lock()
        self.congested = False

    def _window_p99(self) -> float:
        cur = list(self._hist.buckets)
        delta = [c - p for c, p in zip(cur, self._last_buckets)]
        self._last_buckets = cur
        n = sum(delta)
        if n <= 0:
            return 0.0
        want = 0.99 * n
        seen = 0
        for i, c in enumerate(delta):
            seen += c
            if seen >= want:
                return float(1 << i)
        return float(1 << (len(delta) - 1))

    def _fresh_slow_span(self, since_ns: int) -> bool:
        slow_ns = self.cfg.slow_span_us * 1e3
        for sp in obs.SPANS.finished_since(since_ns):
            if (sp.start_ns > since_ns
                    and sp.name in ("store.put", "cluster.put",
                                    "engine.put_batch")
                    and sp.end_ns - sp.start_ns > slow_ns):
                return True
        return False

    def update(self) -> bool:
        """Refresh the congestion verdict (called once per dispatch
        round, not per request).  Returns the new verdict."""
        if not obs.REGISTRY.enabled:
            self.congested = False
            return False
        with self._lock:
            since = self._last_ns
            self._last_ns = obs.now_ns()
            p99 = self._window_p99()
        congested = (p99 > self.cfg.admission_p99_us
                     or self._fresh_slow_span(since))
        if congested and not self.congested:
            obs.emit("runtime.congested", window_p99_us=p99)
        self.congested = congested
        return congested

    def bound(self) -> int:
        return (self.cfg.queue_depth // 2 if self.congested
                else self.cfg.queue_depth)

    def batch(self) -> int:
        return (max(1, self.cfg.max_batch // 2) if self.congested
                else self.cfg.max_batch)


class _Op:
    __slots__ = ("kind", "req", "future")

    def __init__(self, kind: str, req: tuple):
        self.kind = kind           # "put" | "get"
        self.req = req
        self.future: Future = Future()


class _ServletQueue:
    """Bounded MPSC queue: many submitting clients, one dispatcher."""

    def __init__(self, ni: int):
        self.ni = ni
        self.items: deque[_Op] = deque()
        # unranked leaf mutex (never wraps a ranked acquisition);
        # deliberately NOT named *lock so LOCK001's unranked-lock check
        # stays meaningful for real lock attributes
        self._mutex = threading.Lock()
        self.ready = threading.Condition(self._mutex)

    def push(self, op: _Op, bound: int) -> None:
        with self.ready:
            if len(self.items) >= bound:
                raise Backpressure(self.ni, len(self.items), bound)
            self.items.append(op)
            self.ready.notify()

    def pop_run(self, limit: int) -> list[_Op]:
        """Pop a contiguous run of SAME-KIND ops (≤ limit).  Kind runs
        keep per-key program order: a get queued after a put never
        dispatches before it."""
        with self._mutex:
            if not self.items:
                return []
            kind = self.items[0].kind
            run = []
            while (self.items and len(run) < limit
                   and self.items[0].kind == kind):
                run.append(self.items.popleft())
            return run

    def __len__(self) -> int:
        return len(self.items)


class ClusterRuntime:
    """Event-driven front half: per-servlet bounded queues + coalesced
    batch dispatch.  ``submit_put``/``submit_get`` return Futures;
    ``put``/``get`` are their blocking forms.  ``drain()`` dispatches
    everything queued on the caller's thread (deterministic);
    ``start()`` spawns one dispatcher worker per servlet."""

    def __init__(self, cluster, config: RuntimeConfig | None = None):
        self.cluster = cluster
        self.cfg = config or RuntimeConfig()
        self.admission = _AdmissionController(self.cfg)
        self.queues = [_ServletQueue(i)
                       for i in range(len(cluster.nodes))]
        self._threads: list[threading.Thread] = []
        self._stopping = False
        self.daemon: MaintenanceDaemon | None = None

    # ------------------------------------------------------ submission
    def submit_put(self, key, value, branch=None, **kw) -> Future:
        op = _Op("put", (key, value, branch, kw))
        self._admit(key, op)
        return op.future

    def submit_get(self, key, branch=None, **kw) -> Future:
        op = _Op("get", (key, branch, kw))
        self._admit(key, op)
        return op.future

    def _admit(self, key, op: _Op) -> None:
        ni = self.cluster._home_index(key)
        try:
            self.queues[ni].push(op, self.admission.bound())
        except Backpressure:
            obs.inc("runtime_backpressure_total")
            raise
        obs.inc("runtime_submitted_total", labels={"kind": op.kind})

    def put(self, key, value, branch=None, **kw):
        """Blocking submit: queue, drain if unthreaded, await."""
        f = self.submit_put(key, value, branch, **kw)
        if not self._threads:
            self.drain()
        return f.result()

    def get(self, key, branch=None, **kw):
        f = self.submit_get(key, branch, **kw)
        if not self._threads:
            self.drain()
        return f.result()

    def queued(self) -> int:
        return sum(len(q) for q in self.queues)

    # -------------------------------------------------------- dispatch
    def _dispatch(self, run: list[_Op]) -> None:
        """Dispatch one same-kind run as a single coalesced batch."""
        if not run:
            return
        t0 = obs.monotonic()
        if run[0].kind == "put":
            # guarded / fork-on-conflict puts fail per-request (a guard
            # miss must not poison neighbours); plain puts are all-or-
            # nothing (one WriteBuffer flush covers them — on error
            # nothing was published, so the shared failure is truthful)
            plain = [op for op in run
                     if not (op.req[3].get("guard_uid")
                             or op.req[3].get("base_uid"))]
            for op in run:
                if op not in plain:
                    try:
                        k, v, b, kw = op.req
                        op.future.set_result(
                            self.cluster.put(k, v, b, **kw))
                    except BaseException as e:  # noqa: BLE001
                        op.future.set_exception(e)
            if plain:
                try:
                    uids = self.cluster.put_batch(
                        [op.req for op in plain])
                    for op, uid in zip(plain, uids):
                        op.future.set_result(uid)
                except BaseException as e:  # noqa: BLE001
                    for op in plain:
                        op.future.set_exception(e)
        else:
            try:
                vals = self.cluster.get_batch([op.req for op in run])
                for op, v in zip(run, vals):
                    op.future.set_result(v)
            except BaseException:           # isolate the offending get
                for op in run:
                    try:
                        k, b, kw = op.req
                        op.future.set_result(self.cluster.get(k, b, **kw))
                    except BaseException as e:  # noqa: BLE001
                        op.future.set_exception(e)
        if obs.REGISTRY.enabled:
            obs.REGISTRY.histogram("runtime_dispatch_us").observe(
                obs.monotonic() - t0)
            obs.REGISTRY.histogram("runtime_batch_requests").observe(
                len(run) / 1e6)        # histogram buckets are µs-shaped;
            #   feed the raw count through the same power-of-2 buckets
            obs.inc("runtime_coalesced_total", len(run))

    def drain(self) -> int:
        """Synchronously dispatch until every queue is empty.  The
        dispatcher path used by tests and unthreaded callers; worker
        threads run the same per-queue logic.  Returns ops dispatched."""
        done = 0
        while True:
            self.admission.update()
            limit = self.admission.batch()
            idle = True
            for q in self.queues:
                run = q.pop_run(limit)
                if run:
                    idle = False
                    done += len(run)
                    self._dispatch(run)
                if obs.REGISTRY.enabled:
                    obs.set_gauge("runtime_queue_depth", len(q),
                                  {"servlet": str(q.ni)})
            if idle:
                return done

    # -------------------------------------------------------- threading
    def start(self, *, daemon: bool = False,
              daemon_kwargs: dict | None = None) -> "ClusterRuntime":
        """Spawn one dispatcher worker per servlet (and optionally the
        MaintenanceDaemon).  Idempotent; returns self."""
        if self._threads:
            return self
        self._stopping = False
        for q in self.queues:
            t = threading.Thread(target=self._worker, args=(q,),
                                 name=f"repro-dispatch-{q.ni}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if daemon:
            self.daemon = MaintenanceDaemon(self.cluster, runtime=self,
                                            config=self.cfg,
                                            **(daemon_kwargs or {}))
            self.daemon.start()
        return self

    def _worker(self, q: _ServletQueue) -> None:
        while True:
            with q.ready:
                while not q.items and not self._stopping:
                    q.ready.wait(timeout=0.05)
                if self._stopping and not q.items:
                    return
            self.admission.update()
            run = q.pop_run(self.admission.batch())
            self._dispatch(run)
            if obs.REGISTRY.enabled:
                obs.set_gauge("runtime_queue_depth", len(q),
                              {"servlet": str(q.ni)})

    def stop(self) -> None:
        """Drain in-flight queues, stop workers and the daemon."""
        self._stopping = True
        for q in self.queues:
            with q.ready:
                q.ready.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        if self.daemon is not None:
            self.daemon.stop()
            self.daemon = None
        self.drain()              # anything submitted during shutdown

    def __enter__(self) -> "ClusterRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class MaintenanceDaemon:
    """ONE background loop, one budget, every background duty.

    Per tick (time-paced at ``tick_interval_s``), in priority order and
    all drawing down the same ``tick_budget`` of work units:

    1. re-replication slices (data safety first — drains the backlog
       ``Cluster.quarantine_node`` snapshotted);
    2. an incremental-GC slice, if a collection is in flight (the
       daemon can also *begin* epochs on a cycle: ``gc_cycle_ticks``);
    3. a continuous-audit tick (every ``audit_every`` ticks);
    4. ONE servlet's epoch fold (every ``fold_every`` ticks, round-
       robin — staggered so a fold tick never stalls every servlet);
    5. ONE node store's flush/compaction (every ``compact_every``
       ticks, round-robin — the durable store's segment compactor is
       fed by these).

    Foreground load backs the daemon off: when the runtime's queues are
    deep or the routing store's put counter moved a lot since the last
    tick (the same signals ``obs.snapshot()`` exports as
    ``runtime_queue_depth`` gauges and ``store_put_us`` counts), the
    tick runs at a quarter budget and skips the fold/compaction duties.
    """

    def __init__(self, cluster, *, runtime: ClusterRuntime | None = None,
                 config: RuntimeConfig | None = None,
                 audit_budget: int = 1):
        self.cluster = cluster
        self.runtime = runtime
        self.cfg = config or RuntimeConfig()
        self.audit_budget = audit_budget
        self.ticks = 0
        self.collector = None          # in-flight incremental GC epoch
        self._fold_rr = 0
        self._compact_rr = 0
        self._put_seen = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_report: dict = {}

    # ------------------------------------------------------ load signal
    def _backoff(self) -> bool:
        queued = self.runtime.queued() if self.runtime is not None else 0
        rate = 0
        if obs.REGISTRY.enabled:
            count = obs.REGISTRY.histogram(
                "store_put_us", {"backend": "routing"}).count
            rate = count - self._put_seen
            self._put_seen = count
        return (queued > self.cfg.backoff_queued
                or rate > self.cfg.backoff_put_rate)

    # ------------------------------------------------------------ tick
    def tick(self, budget: int | None = None) -> dict:
        """One maintenance tick.  Returns {duty: work done} — also kept
        as ``last_report``."""
        cfg = self.cfg
        self.ticks += 1
        budget = cfg.tick_budget if budget is None else budget
        backoff = self._backoff()
        if backoff:
            budget = max(1, budget // 4)
            obs.inc("daemon_backoffs_total")
        rep = {"tick": self.ticks, "budget": budget, "backoff": backoff,
               "rerep": 0, "gc": 0, "audits": 0, "folds": 0,
               "compactions": 0}
        # 1. re-replication
        if budget > 0:
            n = self.cluster.rereplicate_step(budget)
            rep["rerep"] = n
            budget -= n
        # 2. incremental GC
        if (cfg.gc_cycle_ticks and self.ticks % cfg.gc_cycle_ticks == 0
                and (self.collector is None or not self.collector.active)):
            self.collector = self.cluster.incremental_gc()
        if budget > 0 and self.collector is not None \
                and self.collector.active:
            # the GC slice takes the rest of the grant MINUS one unit
            # per later duty due this very tick — a long collection
            # (many ticks of active slices) must not starve the audit /
            # fold / compaction cadences for its whole epoch
            reserve = 0
            if self.ticks % cfg.audit_every == 0:
                reserve += self.audit_budget
            if not backoff:
                if self.ticks % cfg.fold_every == 0:
                    reserve += 1
                if self.ticks % cfg.compact_every == 0:
                    reserve += 1
            grant = max(1, budget - reserve)
            self.collector.step(grant)
            rep["gc"] = grant
            budget -= grant
        # 3. continuous audit
        if budget > 0 and self.ticks % cfg.audit_every == 0:
            self.cluster.audit_tick(self.audit_budget)
            rep["audits"] = self.audit_budget
            budget -= self.audit_budget
        # folds/compactions yield entirely to a busy foreground: they
        # take servlet/store locks the foreground needs right now
        if not backoff:
            nn = len(self.cluster.nodes)
            # 4. staggered epoch fold
            if budget > 0 and self.ticks % cfg.fold_every == 0:
                self.cluster.commit_epoch_on(self._fold_rr % nn)
                self._fold_rr += 1
                rep["folds"] = 1
                budget -= 1
            # 5. staggered store flush / compaction
            if budget > 0 and self.ticks % cfg.compact_every == 0:
                ni = self._compact_rr % nn
                nd = self.cluster.nodes[ni]
                with nd.store_lock:
                    nd.store.flush()
                self._compact_rr += 1
                rep["compactions"] = 1
        self.last_report = rep
        if obs.REGISTRY.enabled:
            obs.inc("daemon_ticks_total")
            obs.set_gauge("daemon_rerep_backlog",
                          self.cluster.rerep_backlog())
        return rep

    # -------------------------------------------------------- threading
    def start(self) -> "MaintenanceDaemon":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="repro-maintenance",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = self.cfg.tick_interval_s
        while not self._stop.is_set():
            t0 = obs.monotonic()
            self.tick()
            elapsed = obs.monotonic() - t0
            # time pacing: a long tick never stacks the next one early
            self._stop.wait(max(0.0, interval - elapsed))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
