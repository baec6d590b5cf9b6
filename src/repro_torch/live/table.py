"""LiveDB/ArchiveDB split — the forkless flat-state fast path.

ForkBase pays O(log n) POS-Tree I/O on every get/put even though most
traffic only touches the *current* head of a branch.  The Sonic Labs
line of work ("Efficient Forkless Blockchain Databases") splits live
state from the authenticated archive: a flat O(1) table absorbs puts
and serves gets, and the Merkle commitment is computed once per *epoch*
instead of once per operation.

``LiveTable`` is that flat table for one (key, branch) head:

  * ``get``/``put``/``delete`` are dict operations — no tree walk, no
    chunking, no hashing;
  * the accumulated delta folds into the head's POS-Tree Map at an
    epoch boundary (``fold()``, or automatically when ``EpochPolicy``
    thresholds trip): ONE versioned Put whose FMap commit merges the
    sorted dirty keys into the tree in a single batched pass — one
    ``content_hash_many`` dispatch per tree level and one WriteBuffer
    ``put_many`` flush (see ``FMap.commit``'s rebuild fast path);
  * because POS-Tree node boundaries are a function of content alone,
    the folded root is bit-identical to the root of a tree built by
    direct per-op puts — history, forks, proofs and Diff are untouched.

Forks, merges and ``get(uid=...)`` route through the archive; the
engine folds a dirty head before forking or merging it (db.py).  A
branch-table listener marks the table stale when anything else moves
the head (an external put, a merge, a fork landing on this branch), so
a revalidation reloads the archive tree before the next operation —
the dirty overlay survives and reapplies on top of the new head
(last-writer-wins, the same semantics as two successive puts).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .. import obs
from ..core.branch import DEFAULT_BRANCH
from ..core.types import FMap

_DEL = object()          # deletion sentinel in the dirty overlay


@dataclass
class LiveStats:
    """Flat-path counters — the LiveTable analogue of StoreStats."""

    gets: int = 0                 # get() calls served
    hits: int = 0                 # served from the overlay / clean cache
    misses: int = 0               # fell through to the archive tree
    puts: int = 0                 # put() calls absorbed
    deletes: int = 0              # delete() calls absorbed
    folds: int = 0                # epoch folds committed
    auto_folds: int = 0           # folds triggered by EpochPolicy
    folded_keys: int = 0          # dirty keys folded across all epochs
    fold_seconds: float = 0.0     # wall-clock spent folding
    revalidations: int = 0        # archive-head reloads (external moves)
    dirty_bytes: int = 0          # current overlay payload bytes

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(1, self.gets)


@dataclass(frozen=True)
class EpochPolicy:
    """When a put should trigger an automatic fold.  ``None`` disables a
    threshold; the default folds on ~64k dirty keys or 32 MB of dirty
    payload, whichever comes first."""

    max_dirty_keys: int | None = 1 << 16
    max_dirty_bytes: int | None = 32 << 20

    def due(self, dirty_keys: int, dirty_bytes: int) -> bool:
        return ((self.max_dirty_keys is not None
                 and dirty_keys >= self.max_dirty_keys)
                or (self.max_dirty_bytes is not None
                    and dirty_bytes >= self.max_dirty_bytes))


@dataclass
class FoldReport:
    """What one ``fold()`` did."""

    key: bytes
    branch: str
    uid: bytes | None             # new head uid (None: nothing dirty)
    folded_keys: int = 0
    deleted_keys: int = 0
    seconds: float = 0.0


@dataclass
class EpochReport:
    """What one ``ForkBase.commit_epoch()`` did across all live tables."""

    folds: list[FoldReport] = field(default_factory=list)
    attestation: object | None = None

    @property
    def folded_keys(self) -> int:
        return sum(f.folded_keys for f in self.folds)

    @property
    def folded_uids(self) -> list[bytes]:
        return [f.uid for f in self.folds if f.uid is not None]


class LiveTable:
    """Flat head state for one (ForkBase key, branch).

    Obtain through ``ForkBase.live(key, branch)`` — the engine registers
    the staleness listener and folds the table before fork/merge/remove
    of its key.  Direct construction works but leaves those hooks to
    the caller.
    """

    def __init__(self, db, key: bytes, branch: str = DEFAULT_BRANCH, *,
                 policy: EpochPolicy | None = None):
        self.db = db
        self.key = bytes(key)
        self.branch = branch
        self.policy = policy if policy is not None else EpochPolicy()
        self.stats = LiveStats()
        self._dirty: dict[bytes, object] = {}   # overlay; _DEL = delete
        self._clean: dict[bytes, bytes] = {}    # archive read-through cache
        self._absent: set[bytes] = set()        # negative read-through cache
        self._tree = None                       # head Map's POSTree
        self._base_uid: bytes | None = None     # head uid the tree mirrors
        self._stale = True                      # reload before first use

    # ------------------------------------------------------------ state
    @property
    def dirty_count(self) -> int:
        return len(self._dirty)

    @property
    def base_uid(self) -> bytes | None:
        """Head uid of the last fold/revalidation (the archive anchor)."""
        self._revalidate()
        return self._base_uid

    def _mark_stale(self) -> None:
        """Branch-table listener hook: something touched this key."""
        self._stale = True

    def _revalidate(self) -> None:
        """Reload the archive tree if the branch head moved under us
        (external put, merge, fork landing here).  The dirty overlay is
        kept: it reapplies on top of the new head at the next fold —
        exactly what two successive puts would have produced."""
        if not self._stale:
            return
        self._stale = False
        head = self.db.branches.head(self.key, self.branch)
        if head == self._base_uid:
            return
        self.stats.revalidations += 1
        self._base_uid = head
        self._clean.clear()
        self._absent.clear()
        self._tree = None
        if head is not None:
            h = self.db.get(self.key, uid=head)
            self._tree = h.map().tree      # may be None for an empty put

    # ------------------------------------------------------- flat verbs
    def get(self, k: bytes) -> bytes | None:
        """O(1) for every key previously written, read, or preloaded;
        a cold key costs one archive ``find_key`` and is cached."""
        self._revalidate()
        k = bytes(k)
        st = self.stats
        st.gets += 1
        v = self._dirty.get(k)
        if v is not None or k in self._dirty:
            st.hits += 1
            return None if v is _DEL else v  # type: ignore[return-value]
        v = self._clean.get(k)
        if v is not None:
            st.hits += 1
            return v
        if k in self._absent:
            st.hits += 1
            return None
        st.misses += 1
        if self._tree is None or self._tree.total_count == 0:
            self._absent.add(k)
            return None
        found, _, _, gi = self._tree.find_key(k)
        if not found:
            self._absent.add(k)
            return None
        v = self._tree.get_item(gi)[1]
        self._clean[k] = v
        return v

    def put(self, k: bytes, v: bytes) -> None:
        self._revalidate()
        k, v = bytes(k), bytes(v)
        old = self._dirty.get(k)
        if isinstance(old, bytes):
            self.stats.dirty_bytes -= len(k) + len(old)
        self._dirty[k] = v
        self._absent.discard(k)
        st = self.stats
        st.puts += 1
        st.dirty_bytes += len(k) + len(v)
        if self.policy.due(len(self._dirty), st.dirty_bytes):
            st.auto_folds += 1
            self.fold()

    def delete(self, k: bytes) -> None:
        self._revalidate()
        k = bytes(k)
        old = self._dirty.get(k)
        if isinstance(old, bytes):
            self.stats.dirty_bytes -= len(k) + len(old)
        self._dirty[k] = _DEL
        self.stats.deletes += 1

    def load_all(self) -> int:
        """Preload the whole archive map into the clean cache, so every
        subsequent get is a dict hit (the LiveDB serving shape).
        Returns the number of entries loaded."""
        self._revalidate()
        if self._tree is None:
            return 0
        n = 0
        for k, v in self._tree.iter_elements():
            if k not in self._clean and k not in self._dirty:
                self._clean[k] = v
                n += 1
        return n

    def items(self):
        """Sorted merged iteration of the full live state (archive +
        overlay) — the scan verb; does not populate the cache."""
        self._revalidate()
        m = (FMap.from_tree(self._tree) if self._tree is not None
             else FMap(params=self.db.params))
        for k, v in self._dirty.items():
            if v is _DEL:
                m.delete(k)
            else:
                m.set(k, v)
        return m.items()

    # ------------------------------------------------------------- fold
    def fold(self, *, context: bytes = b"") -> FoldReport:
        """Epoch boundary: commit the accumulated delta into the POS-Tree
        archive as ONE versioned Put and adopt the new head.

        The FMap commit underneath merges the sorted dirty keys into the
        tree in one batched pass (build-from-merged-stream when the
        delta dominates, clustered splice otherwise — identical roots
        either way), and the Put's WriteBuffer flushes every chunk with
        a single ``put_many``, which also fires the GC write barrier so
        an in-flight collection shades/rescues everything the fold just
        referenced."""
        self._revalidate()
        rep = FoldReport(self.key, self.branch, self._base_uid)
        if not self._dirty:
            return rep
        t0 = time.perf_counter()
        m = (FMap.from_tree(self._tree) if self._tree is not None
             else FMap(params=self.db.params))
        deleted = 0
        for k, v in self._dirty.items():
            if v is _DEL:
                m.delete(k)
                deleted += 1
            else:
                m.set(k, v)
        uid = self.db.put(self.key, m, self.branch, context=context)
        # adopt: the committed FMap's tree IS the new head's tree
        self._tree = m.tree
        self._base_uid = uid
        self._stale = False          # the head move was our own put
        for k, v in self._dirty.items():
            if v is _DEL:
                self._clean.pop(k, None)
                self._absent.add(k)
            else:
                self._clean[k] = v   # folded keys stay hot
                self._absent.discard(k)
        n = len(self._dirty)
        self._dirty.clear()
        st = self.stats
        st.dirty_bytes = 0
        st.folds += 1
        st.folded_keys += n
        dt = time.perf_counter() - t0
        st.fold_seconds += dt
        rep.uid = uid
        rep.folded_keys = n
        rep.deleted_keys = deleted
        rep.seconds = dt
        # route the self-timed fold into the shared observability layer:
        # one journal event per epoch fold plus the fold-latency histogram
        obs.emit("live.fold", key=self.key, branch=self.branch,
                 folded_keys=n, deleted_keys=deleted, uid=uid,
                 seconds=round(dt, 6))
        obs.observe("live_fold_us", dt)
        return rep


__all__ = ["EpochPolicy", "EpochReport", "FoldReport", "LiveStats",
           "LiveTable"]
