"""Incremental concurrent GC — tri-color mark-and-sweep as a resumable
state machine, safe beside live traffic (ForkBase §4 makes this
tractable because chunks are immutable and content-addressed: only the
root set races).

Phases of one collection epoch:

  begin   epoch-numbered root-set SNAPSHOT: the branch tables (and pin
          sets) are copied once; committers keep moving afterwards.
          Write barriers are installed on every store the mutators
          write through.
  MARK    tri-color: the snapshot roots start gray; ``step(budget)``
          pops at most ``budget`` gray cids, reads them with ONE
          ``get_many`` and grays their unseen references (shared inner
          loop ``collector.expand_refs``).  Black = shaded and
          processed; white = never shaded.  When the gray queue drains,
          the condemned set is frozen in budget-bounded inventory
          slices (still MARK; see ``_freeze_slice``).
  SWEEP   the condemned set is frozen as inventory minus shaded;
          ``step(budget)`` deletes at most ``budget`` condemned cids
          per call (``delete_many`` slices — per owning node in the
          cluster).  The final slice flushes so log tombstones are
          durable.

Write barrier (the safety argument):

  * MARK: every put batch — dedup acks included — is shaded gray.  A
    new version's meta/tree chunks are therefore traversed, which also
    re-marks any *existing* white chunk the new value adopted by dedup
    or by structural reference; anything reachable from a post-snapshot
    head is reachable from shaded chunks or from snapshot roots.
    While the sliced inventory freeze is in progress, shading also
    pulls the cid back out of the partially built condemned set.
  * SWEEP: marking is over, so a put batch is *rescued* instead — its
    cids leave the condemned set before their slice is deleted.  A cid
    already swept is simply re-stored by the put (content addressing
    makes re-put identity-safe).  Chunks first stored during the sweep
    are not in the frozen inventory and cannot be condemned at all.
  * Root barrier (``fork`` from an explicit uid, new pins): during MARK
    the uid is shaded; during SWEEP it is rescued *transitively* through
    the condemned set, because re-rooting a detached subgraph must
    resurrect all of it, not just the head chunk.

Chunks condemned by the snapshot but re-abandoned mid-collection are
floating garbage: they survive this epoch and fall in the next — the
standard snapshot-at-the-beginning trade, never unsafe.

Epoch handshake with ``attest()`` (incremental attestations under
concurrent GC): an attestation commits to the branch heads of
the instant it was issued, but the table keeps moving — a head can be
retired right after signing and swept by the *next* collection, at
which point ``prove_member`` against the freshly signed attestation
dangles.  ``EpochFence`` closes the race: every attestation pins its
committed heads at the current collection epoch, collections root all
pins still inside a one-epoch grace window, and an attestation issued
while a collection is in flight additionally rescues its heads out of
the live condemned set (``attest_fence``).  The contract: proofs
against an attestation stay servable until the SECOND collection after
its issue begins — verifiers refresh at least once per GC epoch (the
attested epoch is stamped into the context, see proof.delta).
"""
from __future__ import annotations

from collections import deque
from enum import Enum

from .. import obs
from ..core.locking import make_lock
from ..errors import CollectionInFlight
from .collector import GCReport, chunk_refs, expand_refs, filter_roots
from .pins import PinSet


_BLOOM_BITS = 1 << 20        # 128 KiB bitset per overflowing epoch


def _bloom_slots(uid: bytes) -> tuple[int, int, int, int]:
    """Four bit positions for one uid.  uids are cryptographic hashes,
    so four distinct 4-byte slices are independent uniform indices — no
    extra hashing needed."""
    u = uid if len(uid) >= 16 else (uid + bytes(16 - len(uid)))
    return (int.from_bytes(u[0:4], "little") % _BLOOM_BITS,
            int.from_bytes(u[4:8], "little") % _BLOOM_BITS,
            int.from_bytes(u[8:12], "little") % _BLOOM_BITS,
            int.from_bytes(u[12:16], "little") % _BLOOM_BITS)


def _bloom_has(bloom: bytearray, uid: bytes) -> bool:
    return all(bloom[s >> 3] & (1 << (s & 7)) for s in _bloom_slots(uid))


class EpochFence:
    """Persistent attestation/collection epoch registry for one engine
    (or one cluster — collections there are cluster-wide).  Survives
    across collector instances so epoch numbers are monotone and pins
    outlive the collection they were issued under.

    Pin memory is bounded: each epoch keeps at most ``max_pins`` exact
    uids; overflow spills into a per-epoch Bloom bitset (128 KiB) that
    ``grace_roots`` intersects with the CURRENT heads (``heads_fn``).
    The trade, stated plainly: a spilled pin protects its uid only
    while the uid is still a live head when the collection starts — a
    head both retired *and* spilled past the cap loses its grace-window
    extension (its proofs may dangle one epoch early).  Bloom false
    positives merely widen the root set, which is always safe.  With
    the default cap (1M pins/epoch) the spill path never engages in
    practice; ``max_pins=None`` disables the bound entirely.

    The fence also carries the floating-garbage handoff between
    consecutive incremental collections: ``last_live`` is the previous
    epoch's shaded (live) set, against which the next epoch's sweep
    counts ``GCReport.floating_garbage`` — chunks that survived one
    collection only because they were orphaned mid-epoch."""

    def __init__(self, grace: int = 1, max_pins: int | None = 1 << 20):
        self.epoch = 0                 # collection epochs begun so far
        self.grace = grace             # epochs a pin outlives its issue
        self.max_pins = max_pins       # exact uids kept per epoch
        self.heads_fn = None           # current-head enumerator (spill path)
        # attests pin from mutator threads while the maintenance daemon
        # begins epochs — rank "fence", a true leaf (never held across
        # heads_fn, which may take servlet locks); core.locking.LOCK_ORDER
        self._fence_lock = make_lock("fence")
        self._pins: dict[int, set[bytes]] = {}
        self._blooms: dict[int, bytearray] = {}
        self._spilled: dict[int, int] = {}
        self.last_live: frozenset = frozenset()   # floating-garbage handoff

    def pin(self, uids) -> int:
        """Record the heads an attestation just committed to; returns
        the epoch number stamped into the attestation."""
        with self._fence_lock:
            e = self.epoch
            if uids:
                cur = self._pins.setdefault(e, set())
                for u in uids:
                    u = bytes(u)
                    if u in cur:
                        continue
                    if self.max_pins is None or len(cur) < self.max_pins:
                        cur.add(u)
                    else:                   # spill: bounded-memory path
                        bloom = self._blooms.get(e)
                        if bloom is None:
                            bloom = self._blooms[e] = bytearray(
                                _BLOOM_BITS // 8)
                        for s in _bloom_slots(u):
                            bloom[s >> 3] |= 1 << (s & 7)
                        self._spilled[e] = self._spilled.get(e, 0) + 1
        if uids:
            obs.inc("gc_fence_pins_total", len(uids))
        return e

    def pin_count(self, epoch: int | None = None) -> int:
        """Pins recorded for one epoch (exact + spilled) — the attest
        path's O(k) claim is asserted against this."""
        e = self.epoch if epoch is None else epoch
        return len(self._pins.get(e, ())) + self._spilled.get(e, 0)

    def begin_epoch(self) -> int:
        """A collection is starting: advance the epoch and expire pins
        that fell out of the grace window."""
        with self._fence_lock:
            self.epoch += 1
            epoch = self.epoch
            for e in [e for e in self._pins if e < epoch - self.grace]:
                del self._pins[e]
            for e in [e for e in self._blooms if e < epoch - self.grace]:
                del self._blooms[e]
                self._spilled.pop(e, None)
        obs.inc("gc_epochs_total")
        obs.set_gauge("gc_epoch", epoch)
        return epoch

    def grace_roots(self) -> set[bytes]:
        """Heads the starting collection must treat as roots: every pin
        still inside the grace window.  Spilled pins are recovered by
        filtering the current heads through the epoch blooms."""
        with self._fence_lock:     # snapshot only — heads_fn runs unlocked
            out: set[bytes] = set()
            for uids in self._pins.values():
                out |= uids
            blooms = [bytes(b) for b in self._blooms.values()]
        if blooms:
            heads = (set(self.heads_fn()) if self.heads_fn is not None
                     else set())
            for bloom in blooms:
                out.update(bytes(h) for h in heads
                           if _bloom_has(bloom, bytes(h)))
        return out


class GCPhase(Enum):
    IDLE = "idle"      # no collection in flight
    MARK = "mark"      # draining the gray queue in budget slices
    SWEEP = "sweep"    # deleting the condemned set in budget slices
    DONE = "done"      # report final; begin() starts the next epoch

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.value


class IncrementalCollector:
    """Resumable collector over one store.  ``begin()`` snapshots the
    roots and installs write barriers; ``step(budget)`` advances the
    mark or sweep by at most ``budget`` chunks and returns the phase;
    ``collect(budget)`` drives a whole epoch to DONE.

    The cluster dispatcher parameterizes the fan-out points:
    ``barrier_stores`` (every store committers write through),
    ``inventory_fn`` (the sweep inventory snapshot) and ``sweep_fn``
    (slice deletion, per owning node) — the state machine itself is
    shared between the embedded engine and the cluster.
    """

    def __init__(self, store, branches=None, pins: PinSet | None = None,
                 extra_roots=(), ref_hooks=(), *, barrier_stores=None,
                 inventory_fn=None, sweep_fn=None, flush_fn=None,
                 on_done=None, fence: EpochFence | None = None):
        self.store = store
        self.branches = branches
        self.pins = pins
        self.extra_roots = set(bytes(u) for u in extra_roots)
        self.ref_hooks = tuple(ref_hooks)
        self._barrier_stores = (list(barrier_stores)
                                if barrier_stores is not None else [store])
        self._inventory_fn = (inventory_fn if inventory_fn is not None
                              else lambda: self.store.iter_cids())
        self._sweep_fn = (sweep_fn if sweep_fn is not None
                          else self._sweep_slice)
        self._flush_fn = (flush_fn if flush_fn is not None
                          else self.store.flush)
        self._on_done = on_done
        self.fence = fence
        # true-thread safety for the barrier/gray-queue state: mutator
        # threads fire _put_barrier/root_barrier while the maintenance
        # daemon drives step() — one RLock serializes them.  Rank
        # "collector": inside servlet locks, outside index/store locks
        # (canonical order in core.locking.LOCK_ORDER; begin() therefore
        # gathers roots BEFORE taking this lock).
        self._collector_lock = make_lock("collector")
        self.phase = GCPhase.IDLE
        self.epoch = 0
        self.report: GCReport | None = None
        self._shaded: set[bytes] = set()        # gray or black (tri-color)
        self._gray: deque[bytes] = deque()
        self._inv_iter = None                   # sliced inventory freeze
        self._condemned: deque[bytes] = deque()
        self._condemned_set: set[bytes] = set()
        self._floating_from: frozenset = frozenset()  # prev epoch's live set
        self._pending_finish = False  # DONE reached; _finish_io still due

    # ------------------------------------------------------------ state
    @property
    def active(self) -> bool:
        return self.phase in (GCPhase.MARK, GCPhase.SWEEP)

    @property
    def marked(self) -> frozenset:
        """The shaded (gray + black) cid set — live this epoch.  Freed
        at DONE (``report.live_chunks`` keeps the count); empty between
        epochs."""
        return frozenset(self._shaded)

    # ------------------------------------------------------------ begin
    def begin(self, extra_roots=()) -> int:
        """Snapshot the root set, install the write barriers and enter
        MARK.  Returns the new epoch number.  The snapshot is a copy:
        branch tables may change freely afterwards (removed heads stay
        live this epoch — floating garbage, collected next epoch)."""
        if self.active:
            raise CollectionInFlight(self.epoch, self.phase)
        # root gathering runs UNLOCKED: all_heads/grace_roots may take
        # servlet locks, which mutators hold while waiting on the
        # collector lock in _put_barrier — holding it here would deadlock
        roots = set(self.extra_roots) | set(bytes(u) for u in extra_roots)
        if self.branches is not None:
            roots |= self.branches.all_heads()      # branch-table copy
        if self.pins is not None:
            roots |= self.pins.uids()
        if self.fence is not None:
            # epoch handshake: heads committed by attestations still in
            # their grace window survive this collection
            self.epoch = self.fence.begin_epoch()
            roots |= self.fence.grace_roots()
        else:
            self.epoch += 1
        frontier, missing = filter_roots(self.store, roots)
        with self._collector_lock:
            if self.active:
                raise CollectionInFlight(self.epoch, self.phase)
            # floating-garbage bound: chunks this epoch sweeps that the
            # PREVIOUS epoch marked live were orphaned mid-collection and
            # survived exactly one extra epoch — the snapshot-at-the-
            # beginning trade, now measured (GCReport.floating_garbage)
            self._floating_from = (self.fence.last_live
                                   if self.fence is not None
                                   else frozenset())
            self.report = GCReport(roots=len(roots), missing_roots=missing,
                                   epoch=self.epoch)
            self._shaded = set(frontier)
            self._gray = deque(frontier)
            self._inv_iter = None
            self._condemned = deque()
            self._condemned_set = set()
            for s in self._barrier_stores:
                s.add_put_listener(self._put_barrier)
                # park the collector lock on the store: one put batch
                # (write + barrier) becomes atomic against step() slices
                s._barrier_lock = self._collector_lock
            self.phase = GCPhase.MARK
        obs.emit("gc.begin", epoch=self.epoch, roots=len(roots),
                 missing_roots=missing)
        return self.epoch

    # ---------------------------------------------------------- barrier
    def _put_barrier(self, cids) -> None:
        """Store-level write barrier: fires on every put batch (ForkBase
        put/merge/truncate_history, WriteBuffer flush) of every store
        this collection watches."""
        with self._collector_lock:
            if self.phase is GCPhase.MARK:
                for c in cids:
                    if c not in self._shaded:
                        self._shaded.add(c)
                        self._gray.append(c)
                        self.report.barriered += 1
                    # the sliced inventory freeze may already have
                    # condemned this cid (it was white when its slice was
                    # snapshotted): shading it must also pull it back out
                    if self._condemned_set:
                        self._condemned_set.discard(c)
            elif self.phase is GCPhase.SWEEP:
                for c in cids:
                    if c in self._condemned_set:
                        self._condemned_set.discard(c)
                        self.report.barriered += 1

    def root_barrier(self, uid: bytes) -> None:
        """Re-rooting barrier: a mutator just made ``uid`` a root (fork
        from an explicit uid, a new pin).  During MARK shading it is
        enough — the mark traverses from it; during SWEEP the rescue is
        transitive through the condemned set, because marking is over
        and a re-rooted detached subgraph must ALL survive."""
        if not self.active:
            return
        uid = bytes(uid)
        with self._collector_lock:   # phase must not flip between check and rescue
            if self.phase is not GCPhase.SWEEP:
                self._put_barrier([uid] if self.store.has(uid) else [])
                return
            self._root_rescue(uid)

    def _root_rescue(self, uid: bytes) -> None:
        if uid not in self._condemned_set:
            return                   # black, already rescued, or swept
        frontier = [uid]
        while frontier:
            for c in frontier:
                self._condemned_set.discard(c)
            present = [c for c, p in zip(frontier,
                                         self.store.has_many(frontier))
                       if p]
            # only cids actually in the store were going to be deleted —
            # a frontier cid the store no longer holds (lost replica,
            # stale cluster index entry) was never rescued from anything
            # and must not inflate the barrier count
            self.report.barriered += len(present)
            nxt: list[bytes] = []
            for raw in self.store.get_many(present):
                refs = list(chunk_refs(raw))
                for hook in self.ref_hooks:   # app-level links too (a
                    refs.extend(hook(raw))    # ckpt manifest's tensor
                nxt.extend(r for r in refs    # roots live through hooks)
                           if r in self._condemned_set)
            frontier = sorted(set(nxt))

    def attest_fence(self, uids) -> None:
        """Epoch handshake with ``attest()``: the heads an attestation
        just committed to must survive this collection — shade (MARK)
        or transitively rescue (SWEEP) each one, exactly like a
        re-rooting event.  Between collections this is a no-op; the
        cross-epoch half of the handshake is the EpochFence pin set
        consumed by the next ``begin()``."""
        for u in uids:
            self.root_barrier(u)

    # ------------------------------------------------------------- step
    def step(self, budget: int = 256) -> GCPhase:
        """Advance the collection by at most ``budget`` chunks (marked
        OR swept OR inventory-frozen — one bounded pause) and return
        the phase.  Each active slice's wall-clock pause is recorded in
        the observability registry (``gc_slice_us`` histogram plus the
        bounded per-slice pause history ``obs.snapshot()['gc']``), and
        phase transitions land in the event journal."""
        if not obs.REGISTRY.enabled or not self.active:
            return self._step_inner(budget)
        before = self.phase
        t0 = obs.monotonic()
        phase = self._step_inner(budget)
        obs.record_gc_pause(str(before), obs.monotonic() - t0,
                            epoch=self.epoch)
        if phase is not before:
            obs.emit("gc.phase", epoch=self.epoch,
                     phase_from=str(before), phase_to=str(phase))
        return phase

    def _step_inner(self, budget: int = 256) -> GCPhase:
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        with self._collector_lock:
            phase = self._step_locked(budget)
            finishing = self._pending_finish
            self._pending_finish = False
        if finishing:
            # the finish flush (fsync + segment compaction) runs OUTSIDE
            # the collector lock: a durable flush can take milliseconds
            # and every mutator's write barrier would stall behind it
            # (LOCK002).  Safe unlocked: phase is DONE, the barriers are
            # unregistered, and only one thread drives step().
            self._finish_io()
        return phase

    def _step_locked(self, budget: int) -> GCPhase:
        if not self.active:
            return self.phase
        self.report.slices += 1
        if self.phase is GCPhase.MARK:
            spent = 0
            if self._gray:
                self.report.mark_rounds += 1
                batch = [self._gray.popleft()
                         for _ in range(min(budget, len(self._gray)))]
                spent = len(batch)
                fresh = expand_refs(self.store, batch, self.ref_hooks,
                                    self._shaded)
                self._gray.extend(fresh)
                if self._condemned_set:
                    # marking resumed mid-freeze (a barrier re-grayed a
                    # put): refs shaded now may sit in the partially
                    # frozen condemned set — pull them back out
                    for c in fresh:
                        self._condemned_set.discard(c)
                if self._gray or spent >= budget:
                    return self.phase
                # gray drained with budget to spare: spend the rest on
                # the inventory freeze NOW.  A mutator putting between
                # every slice re-grays a few chunks each time; if the
                # freeze only ran on steps that BEGAN with an empty gray
                # queue, such a mutator would livelock MARK forever —
                # the collection must make monotone progress per slice.
            self._freeze_slice(budget - spent)
            return self.phase
        # SWEEP: delete up to ``budget`` still-condemned cids
        batch: list[bytes] = []
        while self._condemned and len(batch) < budget:
            c = self._condemned.popleft()
            if c in self._condemned_set:          # not rescued meanwhile
                self._condemned_set.discard(c)
                batch.append(c)
        if batch:
            n, freed = self._sweep_fn(sorted(batch))
            self.report.swept_chunks += n
            self.report.reclaimed_bytes += freed
            if self._floating_from:
                self.report.floating_garbage += sum(
                    1 for c in batch if c in self._floating_from)
        if not self._condemned:
            self._finish()
        return self.phase

    def collect(self, budget: int = 256) -> GCReport:
        """Drive one whole epoch: begin (if idle) and step to DONE."""
        if not self.active:
            self.begin()
        while self.step(budget) is not GCPhase.DONE:
            pass
        return self.report

    # ---------------------------------------------------------- internal
    def _freeze_slice(self, budget: int) -> None:
        """Sliced inventory freeze: the MARK->SWEEP transition
        used to filter the whole ``iter_cids()`` inventory against the
        shaded set in one O(store) pause; now each step() consumes at
        most ``budget`` inventory cids, building the condemned set
        across as many bounded slices as the store is large.

        Safety while the freeze is in progress: the phase stays MARK, so
        the write barrier keeps shading new puts gray (and pulls any
        already-condemned cid back out of the condemned set), and a
        non-empty gray queue is drained by mark slices before the next
        freeze slice — a cid enters SWEEP condemned only if it was
        still white after every barrier event that touched it."""
        if self._inv_iter is None:
            # backends snapshot iter_cids() as a cid list (a pointer
            # copy, no chunk payloads); the O(n) membership filtering
            # below is what gets sliced.  A generation list would shed
            # the copy too — the production shape.
            self._inv_iter = iter(self._inventory_fn())
        taken = 0
        for cid in self._inv_iter:
            if cid not in self._shaded and cid not in self._condemned_set:
                self._condemned.append(cid)
                self._condemned_set.add(cid)
            taken += 1
            if taken >= budget:
                return
        # iterator exhausted: the condemned set is frozen — enter SWEEP.
        # The deque keeps inventory order (each sweep slice sorts its
        # own batch); a global sort here would be an O(dead) pause.
        self._inv_iter = None
        self.report.live_chunks = len(self._shaded)
        self.phase = GCPhase.SWEEP
        if not self._condemned_set:
            self._finish()

    def _sweep_slice(self, cids) -> tuple[int, int]:
        r0 = self.store.stats.reclaimed_bytes
        n = self.store.delete_many(cids)
        return n, self.store.stats.reclaimed_bytes - r0

    def _compacted_total(self) -> int:
        """Segment-compaction bytes across every store the finish flush
        touches (per-node on a cluster, else the engine's store)."""
        cluster = getattr(self.store, "cluster", None)
        if cluster is not None:
            return sum(n.store.stats.compacted_bytes
                       for n in cluster.nodes)
        return self.store.stats.compacted_bytes

    def _finish(self) -> None:
        """In-memory epilogue, caller holds the collector lock.  The
        blocking half (store flush/compaction, completion callbacks)
        is deferred to ``_finish_io`` which ``_step_inner`` runs after
        releasing the lock."""
        for s in self._barrier_stores:
            s.remove_put_listener(self._put_barrier)
            s._barrier_lock = None
        if self.fence is not None:
            # floating-garbage handoff: the next epoch counts its sweep
            # against this epoch's live set (one O(live) cid set held on
            # the persistent fence between collections)
            self.fence.last_live = frozenset(self._shaded)
        self._gray.clear()
        self._inv_iter = None
        self._condemned.clear()
        self._condemned_set = set()
        self._shaded = set()         # O(live) memory is the epoch's, not ours
        self.phase = GCPhase.DONE
        self._pending_finish = True

    def _finish_io(self) -> None:
        """Blocking finish work, run with NO locks held (fixes the
        LOCK002 finding: the old ``_finish`` fsync'd every node store —
        the segment compaction feed — while the collector lock stalled
        every write barrier in the cluster)."""
        if self.report.swept_chunks:
            c0 = self._compacted_total()
            self._flush_fn()         # durable tombstones, like collect();
            #   on a durable store this flush IS the compaction feed
            self.report.compacted_bytes += self._compacted_total() - c0
        obs.record_gc_report(self.report)
        obs.emit("gc.done", mode="incremental", epoch=self.epoch,
                 slices=self.report.slices,
                 swept=self.report.swept_chunks,
                 reclaimed_bytes=self.report.reclaimed_bytes,
                 barriered=self.report.barriered)
        if self._on_done is not None:
            self._on_done(self.report)
