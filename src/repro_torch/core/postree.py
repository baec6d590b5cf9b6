"""Pattern-Oriented-Split Tree (paper §4.3, Fig. 6, Algorithm 1).

A Merkle-hashed B+-tree whose node boundaries are *content patterns*:
  * leaf level — rolling-hash patterns over the serialized element stream
    (element-aligned, §4.3.2);
  * index levels — cid-bit patterns over child entries (P', §4.3.3).

Node boundaries are a deterministic function of content alone, independent
of edit order.  Consequences (all property-tested):
  * equal content  <=> identical root cid (dedup + tamper evidence);
  * updates are copy-on-write and touch O(changed chunks) nodes;
  * Diff of two trees skips identical-cid subtrees.

The tree object keeps materialized per-level entry lists (levels[0] = leaf
entries ... levels[-1] = [root]); chunks are the persistent representation.
Incremental commits re-chunk only from the first affected leaf until the new
cut sequence re-aligns with the old one (guaranteed once the rolling window
has slid past the edit), then splice.  Index levels are recomputed from the
leaf entries — unchanged nodes re-serialize to identical bytes, so the store
dedups them and only the O(log n) changed path is newly written.
"""
from __future__ import annotations

import bisect
from difflib import SequenceMatcher

import numpy as np

from . import chunk as ck
from .chunk import Entry
from .chunker import (ChunkParams, DEFAULT_PARAMS, boundary_bitmap,
                      cut_bytes, cut_elements, cut_segments, index_cuts)
from .. import obs
from ..errors import InvariantViolation
from ..storage import WriteBuffer

SORTED_KINDS = (ck.SET, ck.MAP)


# ---------------------------------------------------------------- navigation
# Deterministic child selection over decoded index entries.  Shared by the
# tree walks here and by the *stateless* proof verifier (proof package):
# both sides must pick the same child for the same (entries, pos/key), or
# a genuine proof would fail to verify.

def child_by_pos(entries: list[Entry], pos: int) -> tuple[int, int]:
    """(child index, items preceding it) for global item position ``pos``
    within a node whose subtree counts sum over ``pos``; raises IndexError
    when pos is outside the node (a forged position in a proof)."""
    base = 0
    for i, e in enumerate(entries):
        if pos < base + e.count:
            return i, base
        base += e.count
    raise IndexError(pos)


def child_by_key(entries: list[Entry], key: bytes) -> int:
    """First child whose max key covers ``key`` (clamped to the last child
    so past-the-end keys resolve to the rightmost leaf, as in find_key)."""
    ks = [e.key for e in entries]
    return min(bisect.bisect_left(ks, key), len(entries) - 1)


# ------------------------------------------------------ blob splice clusters
# A blob splice re-chunks each locality cluster of its edits on its own,
# in the old leaf level's coordinates (POSTree.splice_bytes).  That gives
# the tree a whole rebuild gives when the old leaves were cut with the same
# params: a cluster's window ends before the next cluster's first leaf,
# and it resyncs on an old boundary at least a rolling window past its
# last edit, so the next cluster starts on a cut of the new stream and
# its warm-up bytes are unedited.  Leaves cut with other params (a blob
# built at the default params inside an engine with others) are not what
# the splice's params cut between two clusters: there the edits form one
# cluster, from the first edit to the last, and the result is the one
# re-chunking that whole span gives.

class _Cluster:
    """Edits (sorted, old coordinates) re-chunked as one span: from leaf
    j0, the leaf of its first edit, after the warm-up bytes before it, to
    the first old leaf boundary its cuts resync at.  ``resume`` is that
    old leaf's index once found (None while open); ``cuts`` and ``buf``
    then give its new leaves."""

    def __init__(self, edits: list, j0: int, jE: int, base: int):
        self.edits = list(edits)
        self.j0, self.jE = j0, jE           # leaves of first and last edit
        self.base = base                    # leaf j0's offset
        self.last_end = max(e[1] for e in edits)
        self.grow = max(2, jE - j0 + 1)     # leaves read past jE
        self.warm: bytes | None = None      # window-1 bytes before leaf j0
        self.resume: int | None = None
        # the attempt's last leaf read, the window's bytes with the edits
        # applied and their change in length
        self.jx = j0
        self.buf, self.delta = b"", 0
        # once closed: the new leaves' ends in ``buf``, chunks and sizes
        self.cuts: list[int] = []
        self.raws: list[bytes] = []
        self.sizes: list[int] = []

    def reach(self, last: int) -> int:
        """Last leaf of the next attempt's window."""
        return min(self.jE + self.grow, last)

    def absorb(self, other: "_Cluster") -> None:
        self.edits += other.edits
        self.jE = max(self.jE, other.jE)
        self.last_end = max(self.last_end, other.last_end)
        self.grow = max(self.grow, other.grow, self.jE - self.j0 + 1)
        self.resume = None

    def apply(self, old: bytes) -> None:
        """The bytes of leaves j0 to jx with the edits applied in one
        forward pass."""
        old = memoryview(old)
        parts: list = []
        pos = 0
        for s, e, rep in self.edits:
            parts += (old[pos:s - self.base], rep)
            pos = e - self.base
        parts.append(old[pos:])
        self.buf = b"".join(parts)
        self.delta = len(self.buf) - len(old)

    def resync(self, cuts: list[int], cum: np.ndarray, last: int,
               window: int) -> None:
        """Close at the first new cut that lands on an old leaf boundary
        once the rolling window has slid past the last edit (or at the
        stream's end); else double the window for the next attempt."""
        at_end = self.jx == last
        c = np.asarray(cuts if at_end else cuts[:-1], dtype=np.int64)
        old_off = c - self.delta + self.base
        idx = np.minimum(np.searchsorted(cum, old_off), len(cum) - 1)
        stable_from = (self.last_end - self.base) + self.delta + window
        hit = np.flatnonzero((c >= stable_from) & (old_off >= self.last_end)
                             & (cum[idx] == old_off))
        if hit.size:
            k = int(hit[0])
            self.cuts, self.resume = cuts[:k + 1], int(idx[k]) + 1
        elif at_end:
            self.cuts, self.resume = cuts, last + 1
        else:
            self.grow *= 2

    def encode(self) -> None:
        self.raws, self.sizes = [], []
        start = 0
        for c in self.cuts:
            self.raws.append(ck.encode_chunk(ck.BLOB, self.buf[start:c]))
            self.sizes.append(c - start)
            start = c


def _merge_reaching(clusters: list[_Cluster], last: int) -> list[_Cluster]:
    """Merge each open cluster with the clusters after it that its next
    window reaches: a window that holds another cluster's first leaf has
    to carry that cluster's edits, and resync past them."""
    out: list[_Cluster] = []
    for cl in clusters:
        prev = out[-1] if out else None
        if (prev is not None and prev.resume is None
                and prev.reach(last) >= cl.j0):
            prev.absorb(cl)
        else:
            out.append(cl)
    return out


class POSTree:
    def __init__(self, store, kind: int, levels: list[list[Entry]],
                 params: ChunkParams = DEFAULT_PARAMS, *,
                 cut_by_params: bool = False):
        self.store = store
        self.kind = kind
        self.levels = levels
        self.params = params
        # the leaf level is known to be what cutting the whole stream with
        # ``params`` gives (a build, or a root its engine registered), so
        # a blob splice may re-chunk each cluster of edits on its own
        self.cut_by_params = cut_by_params
        self._buf: WriteBuffer | None = None      # active commit batch
        self._leaf_cache: dict[int, list] = {}
        self._cum: np.ndarray | None = None       # leaf cumulative counts
        self._keycache: list[bytes] | None = None  # leaf max keys (sorted)

    # ------------------------------------------------- batched chunk I/O
    # All chunks written during one build/splice commit accumulate in a
    # WriteBuffer and reach the store as a single put_many (§4.6.1); reads
    # during the commit see pending chunks through the buffer.
    def _open_batch(self, sink=None) -> None:
        """``sink`` lets a caller-owned batch (db.put's per-value
        WriteBuffer) absorb this commit's chunks, so incremental splices
        ride the same single put_many as the value's meta chunk."""
        if self._buf is None:
            self._buf = WriteBuffer(sink if sink is not None else self.store)

    def _commit_batch(self) -> None:
        if self._buf is not None:
            self._buf.flush()
            self._buf = None

    def _put_chunks(self, raws: list[bytes]) -> list[bytes]:
        tgt = self._buf if self._buf is not None else self.store
        return tgt.put_many(raws)

    def _get_raw(self, cid: bytes) -> bytes:
        src = self._buf if self._buf is not None else self.store
        return src.get(cid)

    # ------------------------------------------------------------ build
    @classmethod
    def build_bytes(cls, store, data: np.ndarray | bytes,
                    params: ChunkParams = DEFAULT_PARAMS) -> "POSTree":
        data = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
            data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
        if data.size == 0:
            return cls._empty(store, ck.BLOB, params)
        cuts = cut_bytes(data, params)
        buf = WriteBuffer(store)
        raws, counts = [], []
        start = 0
        for c in cuts:
            raws.append(ck.encode_chunk(ck.BLOB, data[start:c].tobytes()))
            counts.append(c - start)
            start = c
        leaves = [Entry(cid, cnt)
                  for cid, cnt in zip(buf.put_many(raws), counts)]
        return cls._from_leaves(store, ck.BLOB, leaves, params, buf=buf)

    @classmethod
    def build_elements(cls, store, kind: int, elements: list[bytes],
                       keys: list[bytes] | None = None,
                       params: ChunkParams = DEFAULT_PARAMS) -> "POSTree":
        """elements: already-serialized, self-delimiting elements
        (pack_lv for List/Set, pack_kv for Map); keys: per-element sort key
        for sorted kinds."""
        if not elements:
            return cls._empty(store, kind, params)
        stream = np.frombuffer(b"".join(elements), dtype=np.uint8)
        bitmap = boundary_bitmap(stream, params)
        lengths = [len(e) for e in elements]
        cuts = cut_elements(lengths, bitmap, params)
        buf = WriteBuffer(store)
        raws, counts, ekeys = [], [], []
        start = 0
        is_sorted = kind in SORTED_KINDS
        for c in cuts:
            raws.append(ck.encode_chunk(kind, b"".join(elements[start:c])))
            counts.append(c - start)
            ekeys.append(keys[c - 1] if (is_sorted and keys is not None)
                         else None)
            start = c
        leaves = [Entry(cid, cnt, key) for cid, cnt, key
                  in zip(buf.put_many(raws), counts, ekeys)]
        return cls._from_leaves(store, kind, leaves, params, buf=buf)

    @classmethod
    def _empty(cls, store, kind: int, params: ChunkParams) -> "POSTree":
        raw = ck.encode_chunk(kind, b"")
        key = b"" if kind in SORTED_KINDS else None
        return cls(store, kind, [[Entry(store.put(raw), 0, key)]], params,
                   cut_by_params=True)

    @classmethod
    def _from_leaves(cls, store, kind, leaves, params,
                     buf: WriteBuffer | None = None) -> "POSTree":
        tree = cls(store, kind, [leaves], params, cut_by_params=True)
        tree._buf = buf if buf is not None else WriteBuffer(store)
        tree._rebuild_index()
        tree._commit_batch()
        return tree

    @classmethod
    def from_root(cls, store, kind: int, root_cid: bytes,
                  params: ChunkParams = DEFAULT_PARAMS, *,
                  cut_by_params: bool = False) -> "POSTree":
        """Materialize the index (not the leaves) from a stored root;
        ``cut_by_params`` when the caller knows ``params`` cut its leaves."""
        with obs.trace("tree.load"):
            root_raw = store.get(root_cid)
            raw = ck.chunk_payload(root_raw)
            rtype = ck.chunk_type(root_raw)
            if rtype in (ck.UINDEX, ck.SINDEX):
                # walk down, collecting each level's entries; each level is
                # fetched with ONE batched get_many, not a get per node
                levels_desc = []
                entries = (ck.decode_sindex if rtype == ck.SINDEX
                           else ck.decode_uindex)(raw)
                cur = entries
                while True:
                    levels_desc.append(cur)
                    child = store.get(cur[0].cid)
                    ctype = ck.chunk_type(child)
                    if ctype not in (ck.UINDEX, ck.SINDEX):
                        break
                    dec = (ck.decode_sindex if ctype == ck.SINDEX
                           else ck.decode_uindex)
                    nxt = []
                    for raw_c in store.get_many([e.cid for e in cur]):
                        nxt.extend(dec(ck.chunk_payload(raw_c)))
                    cur = nxt
                root_count = sum(e.count for e in levels_desc[0])
                root_key = levels_desc[0][-1].key
                levels = list(reversed(levels_desc))
                levels.append([Entry(root_cid, root_count, root_key)])
                return cls(store, kind, levels, params,
                           cut_by_params=cut_by_params)
            # root is a single leaf
            count, key = cls._leaf_stats(kind, raw)
            return cls(store, kind, [[Entry(root_cid, count, key)]], params,
                       cut_by_params=cut_by_params)

    @staticmethod
    def _leaf_stats(kind: int, payload: bytes) -> tuple[int, bytes | None]:
        if kind == ck.BLOB:
            return len(payload), None
        if kind == ck.MAP:
            els = ck.unpack_kv_stream(payload)
            return len(els), (els[-1][0] if els else b"")
        els = ck.unpack_lv_stream(payload)
        key = (els[-1] if els else b"") if kind == ck.SET else None
        return len(els), key

    # ------------------------------------------------------------ props
    @property
    def root_cid(self) -> bytes:
        return self.levels[-1][0].cid

    @property
    def total_count(self) -> int:
        return self.levels[-1][0].count

    @property
    def height(self) -> int:
        return len(self.levels)

    def node_cids(self) -> set[bytes]:
        """All chunk cids reachable from this tree (for GC / stats)."""
        out = set()
        for lvl in self.levels:
            out.update(e.cid for e in lvl)
        return out

    # ------------------------------------------------------------ reads
    def _cum_counts(self) -> np.ndarray:
        if self._cum is None:
            self._cum = np.cumsum(
                np.fromiter((e.count for e in self.levels[0]), dtype=np.int64,
                            count=len(self.levels[0])))
        return self._cum

    def _leaf_payload(self, i: int) -> bytes:
        return ck.chunk_payload(self._get_raw(self.levels[0][i].cid))

    def _parse_leaf(self, payload: bytes):
        if self.kind == ck.BLOB:
            return np.frombuffer(payload, dtype=np.uint8)
        if self.kind == ck.MAP:
            return ck.unpack_kv_stream(payload)
        return ck.unpack_lv_stream(payload)

    def leaf_elements(self, i: int) -> list:
        """Parsed elements of leaf i (bytes-array for Blob, kv tuples for
        Map, bytes for List/Set)."""
        if i in self._leaf_cache:
            return self._leaf_cache[i]
        els = self._parse_leaf(self._leaf_payload(i))
        if len(self._leaf_cache) > 256:
            self._leaf_cache.clear()
        self._leaf_cache[i] = els
        return els

    def prefetch_leaves(self, j0: int, j1: int) -> None:
        """Pull leaves [j0, j1) into the parse cache with ONE batched
        ``get_many`` over the uncached cids — the read-side analogue of
        the WriteBuffer's batched flush.  Range reads and scans that
        touch k leaves cost one store round-trip instead of k."""
        need = [j for j in range(j0, j1) if j not in self._leaf_cache]
        if len(need) < 2:
            return                       # 0/1 leaves: plain path is fine
        src = self._buf if self._buf is not None else self.store
        raws = src.get_many([self.levels[0][j].cid for j in need])
        if len(self._leaf_cache) + len(need) > 256:
            self._leaf_cache.clear()
        for j, raw in zip(need, raws):
            self._leaf_cache[j] = self._parse_leaf(ck.chunk_payload(raw))

    def leaf_of_item(self, pos: int) -> tuple[int, int]:
        """(leaf index, local offset) of global item position pos."""
        cum = self._cum_counts()
        j = int(np.searchsorted(cum, pos, side="right"))
        j = min(j, len(cum) - 1)
        base = int(cum[j - 1]) if j > 0 else 0
        return j, pos - base

    def get_item(self, pos: int):
        if not (0 <= pos < self.total_count):
            raise IndexError(pos)
        j, off = self.leaf_of_item(pos)
        return self.leaf_elements(j)[off]

    def read_bytes(self, start: int, length: int) -> bytes:
        if self.kind != ck.BLOB:
            raise InvariantViolation(f"read_bytes on non-blob kind {self.kind}")
        end = min(start + length, self.total_count)
        if end <= start:
            return b""
        with obs.trace("tree.read"):
            j0, off0 = self.leaf_of_item(start)
            self.prefetch_leaves(j0, self.leaf_of_item(end - 1)[0] + 1)
            out = []
            pos = start
            j = j0
            while pos < end:
                els = self.leaf_elements(j)
                lo = off0 if j == j0 else 0
                hi = min(len(els), lo + (end - pos))
                out.append(els[lo:hi].tobytes())
                pos += hi - lo
                j += 1
            return b"".join(out)

    def _leaf_keys(self) -> list[bytes]:
        if self._keycache is None:
            self._keycache = [e.key for e in self.levels[0]]
        return self._keycache

    def find_key(self, key: bytes):
        """Sorted kinds: (found, leaf_idx, local_idx, global_idx)."""
        if self.kind not in SORTED_KINDS:
            raise InvariantViolation(f"find_key on unsorted kind {self.kind}")
        lk = self._leaf_keys()
        j = bisect.bisect_left(lk, key)
        if j >= len(lk):
            j = len(lk) - 1
        els = self.leaf_elements(j)
        keys = [e[0] for e in els] if self.kind == ck.MAP else els
        li = bisect.bisect_left(keys, key)
        cum = self._cum_counts()
        base = int(cum[j - 1]) if j > 0 else 0
        found = li < len(keys) and keys[li] == key
        return found, j, li, base + li

    def iter_elements(self):
        n = len(self.levels[0])
        for blk in range(0, n, 128):
            hi = min(blk + 128, n)
            self.prefetch_leaves(blk, hi)
            for i in range(blk, hi):
                yield from self.leaf_elements(i)

    # ------------------------------------------------------ lookup via tree
    def descend_key(self, key: bytes):
        """Pure tree-walk lookup (no materialized leaf keys) — exercises the
        on-disk SIndex path the way a remote client would (paper §3.4)."""
        if self.kind not in SORTED_KINDS:
            raise InvariantViolation(f"descend_key on unsorted kind {self.kind}")
        node = self.levels[-1][0]
        raw = self.store.get(node.cid)
        while ck.chunk_type(raw) in (ck.UINDEX, ck.SINDEX):
            entries = ck.decode_sindex(ck.chunk_payload(raw))
            ks = [e.key for e in entries]
            i = min(bisect.bisect_left(ks, key), len(entries) - 1)
            raw = self.store.get(entries[i].cid)
        if self.kind == ck.MAP:
            for k, v in ck.unpack_kv_stream(ck.chunk_payload(raw)):
                if k == key:
                    return v
            return None
        return key if key in ck.unpack_lv_stream(ck.chunk_payload(raw)) else None

    # ------------------------------------------------------- audit paths
    def audit_path(self, *, pos: int | None = None,
                   key: bytes | None = None) -> tuple[list[bytes], bytes]:
        """Membership-proof extraction hook (proof subsystem): the raw
        chunk chain from the root down to the leaf holding item ``pos``
        (any kind) or sorted-kind ``key`` — exactly the nodes a stateless
        verifier needs to recompute the root cid.  Returns
        (index node raws root-down, leaf raw)."""
        if (pos is None) == (key is None):
            raise InvariantViolation("audit_path needs exactly one of pos/key")
        if key is not None and self.kind not in SORTED_KINDS:
            raise InvariantViolation(f"audit_path by key on unsorted kind {self.kind}")
        raw = self._get_raw(self.root_cid)
        index_raws: list[bytes] = []
        while ck.chunk_type(raw) in (ck.UINDEX, ck.SINDEX):
            dec = (ck.decode_sindex if ck.chunk_type(raw) == ck.SINDEX
                   else ck.decode_uindex)
            entries = dec(ck.chunk_payload(raw))
            if pos is not None:
                child, base = child_by_pos(entries, pos)
                pos -= base
            else:
                child = child_by_key(entries, key)
            index_raws.append(raw)
            raw = self._get_raw(entries[child].cid)
        return index_raws, raw

    # ------------------------------------------------------------ commit
    def _rebuild_index(self) -> None:
        """Recompute index levels from levels[0] (P' cid patterns, §4.3.3).
        Unchanged nodes hash to their old cids and dedup in the store."""
        with obs.trace("tree.index"):
            self.levels = [self.levels[0]]
            self._cum = None
            self._keycache = None
            self._leaf_cache.clear()
            entries = self.levels[0]
            is_sorted = self.kind in SORTED_KINDS
            while len(entries) > 1:
                cuts = index_cuts([e.cid for e in entries], self.params)
                raws, counts, keys = [], [], []
                start = 0
                for c in cuts:
                    group = entries[start:c]
                    raws.append(ck.encode_sindex(group) if is_sorted
                                else ck.encode_uindex(group))
                    counts.append(sum(e.count for e in group))
                    keys.append(group[-1].key if is_sorted else None)
                    start = c
                nxt = [Entry(cid, cnt, key) for cid, cnt, key
                       in zip(self._put_chunks(raws), counts, keys)]
                self.levels.append(nxt)
                entries = nxt

    def _warmup_bytes(self, j0: int, payload=None) -> tuple[bytes, int]:
        """Last window-1 bytes of the stream before leaf j0, and the
        number of leaves read for them (by ``payload``, a leaf index to
        its payload; ``_leaf_payload`` by default)."""
        payload = payload or self._leaf_payload
        need = self.params.window - 1
        parts: list[bytes] = []
        got = 0
        j = j0 - 1
        while j >= 0 and got < need:
            p = payload(j)
            take = p[-(need - got):]
            parts.append(take)
            got += len(take)
            j -= 1
        return b"".join(reversed(parts)), len(parts)

    def _payloads_of(self, clusters: list[_Cluster],
                     cum: np.ndarray) -> dict[int, bytes]:
        """The payloads of the leaves the clusters' next attempt reads
        (the warm-up leaves of each without its warm-up bytes yet, and j0
        to jx), by leaf index, from one ``get_many``."""
        need: set[int] = set()
        for cl in clusters:
            lo = cl.j0
            if cl.warm is None:
                lo = int(np.searchsorted(
                    cum, max(0, cl.base - (self.params.window - 1)),
                    side="right"))
            need.update(range(min(lo, cl.j0), cl.jx + 1))
        js = sorted(need)
        raws = self._buf.get_many([self.levels[0][j].cid for j in js])
        return dict(zip(js, map(ck.chunk_payload, raws)))

    def splice_bytes(self, edits: list[tuple[int, int, bytes]],
                     sink=None) -> None:
        """Blob: apply [(start, end, replacement)] byte splices (sorted,
        non-overlapping) and incrementally re-chunk.

        The edits fall into locality clusters.  Each cluster is re-chunked
        from its first leaf to the first old leaf boundary where its cuts
        resync, in the old leaf level's coordinates; a cluster whose window
        reaches the next cluster's first leaf merges with it, and every
        edit is in one cluster unless ``cut_by_params``.  A round reads
        every open cluster's leaves in one checked ``get_many`` (a tree
        not ``cut_by_params``: leaf by leaf, in the reference's order, so
        a tiered store demotes as under the reference), hands the bitmap
        every open cluster's bytes in one stream, and the new leaves of
        all clusters are put in one batch, so 100 edits
        scattered over a large blob re-chunk ~100 small spans, not the
        whole range between the first and the last edit.

        One ``tree.splice`` span, whose attributes count the edits, the
        clusters re-chunked, the leaves read, the bytes handed to the
        bitmap (``rechunked``), each summed over every round, the leaves
        written and the rounds (``attempts``);
        each round's phases are the spans ``splice.gather``,
        ``splice.apply``, ``splice.chunk`` and ``splice.encode``, then
        ``tree.index``."""
        if self.kind != ck.BLOB:
            raise InvariantViolation(f"splice_bytes on non-blob kind {self.kind}")
        if not edits:
            return
        edits = sorted(edits)
        with obs.trace("tree.splice", edits=len(edits)) as sp:
            self._open_batch(sink)
            leaves = self.levels[0]
            last = len(leaves) - 1
            cum = self._cum_counts()
            starts = np.array([e[0] for e in edits], dtype=np.int64)
            ends = np.array([e[1] for e in edits], dtype=np.int64)
            j_first = np.minimum(np.searchsorted(cum, starts, side="right"),
                                 last)
            j_last = np.minimum(np.searchsorted(
                cum, np.maximum(ends - 1, starts), side="right"), last)
            bases = np.where(j_first > 0, cum[j_first - 1], 0)
            if self.cut_by_params:
                clusters = [_Cluster([e], int(a), int(b), int(o))
                            for e, a, b, o in zip(edits, j_first, j_last,
                                                  bases)]
            else:
                # one span, from the leaf of the first edit to that of the
                # last end (or of the first start, if later)
                jE = min(int(np.searchsorted(
                    cum, max(int(ends.max()) - 1, int(starts[0])),
                    side="right")), last)
                clusters = [_Cluster(edits, int(j_first[0]), jE,
                                     int(bases[0]))]
            counts = {"clusters": 0, "leaves_read": 0, "rechunked": 0,
                      "new_leaves": 0, "attempts": 0}
            window = self.params.window
            while True:
                counts["attempts"] += 1
                clusters = _merge_reaching(clusters, last)
                opened = [cl for cl in clusters if cl.resume is None]
                with obs.trace("splice.gather"):
                    for cl in opened:
                        cl.jx = cl.reach(last)
                    payload = self._leaf_payload
                    if self.cut_by_params:
                        # every open cluster's leaves in one checked batch
                        # (else leaf by leaf, as the reference reads)
                        got = self._payloads_of(opened, cum)
                        payload = (lambda j: got[j] if j in got
                                   else self._leaf_payload(j))
                    olds = []
                    for cl in opened:
                        if cl.warm is None:
                            cl.warm, n = self._warmup_bytes(cl.j0, payload)
                            counts["leaves_read"] += n
                        olds.append(b"".join(map(payload,
                                                 range(cl.j0, cl.jx + 1))))
                        counts["leaves_read"] += cl.jx + 1 - cl.j0
                with obs.trace("splice.apply"):
                    for cl, old in zip(opened, olds):
                        cl.apply(old)
                with obs.trace("splice.chunk"):
                    parts, segments, at = [], [], 0
                    for cl in opened:
                        parts += (cl.warm, cl.buf)
                        lo = at + len(cl.warm)
                        at = lo + len(cl.buf)
                        segments.append((lo, at))
                    stream = np.frombuffer(b"".join(parts), dtype=np.uint8)
                    counts["rechunked"] += len(stream)
                    counts["clusters"] += len(opened)
                    bitmap = boundary_bitmap(stream, self.params)
                    for cl, cuts in zip(opened, cut_segments(
                            bitmap, segments, self.params)):
                        cl.resync(cuts, cum, last, window)
                done = all(cl.resume is not None for cl in clusters)
                with obs.trace("splice.encode"):
                    for cl in opened:
                        if cl.resume is not None:
                            cl.encode()
                    if done:
                        cids = iter(self._put_chunks(
                            [r for cl in clusters for r in cl.raws]))
                if done:
                    break
            level: list[Entry] = []
            prev = 0
            for cl in clusters:
                level += leaves[prev:cl.j0]
                level += [Entry(next(cids), n) for n in cl.sizes]
                counts["new_leaves"] += len(cl.sizes)
                prev = cl.resume
            level += leaves[prev:]
            self.levels[0] = level or self._empty(self.store, ck.BLOB,
                                                  self.params).levels[0]
            self._rebuild_index()
            self._commit_batch()
            if sp is not None:
                sp.set(**counts)

    def splice_elements(self, edits: list[tuple[int, int, list[bytes],
                                                list[bytes] | None]],
                        sink=None) -> None:
        """List/Set/Map: [(start, end, new_serialized_elems, new_keys)]
        element-space splices (sorted, non-overlapping).

        Scattered edits are partitioned into locality clusters and applied
        as independent spans in DESCENDING order (later spans never shift
        earlier indices), so a 100-key update on a 5M-row map re-chunks
        ~100 leaves, not the whole range between the first and last key.
        The index levels are recomputed once at the end."""
        if self.kind == ck.BLOB:
            raise InvariantViolation("splice_elements on blob tree")
        if not edits:
            return
        self._open_batch(sink)
        # cluster by element distance (~2 leaves apart -> same span)
        avg_leaf = max(1, self.total_count // max(1, len(self.levels[0])))
        gap = 2 * avg_leaf
        clusters: list[list] = [[edits[0]]]
        for e in edits[1:]:
            if e[0] - clusters[-1][-1][1] <= gap:
                clusters[-1].append(e)
            else:
                clusters.append([e])
        for cl in reversed(clusters):
            self._splice_span_elements(cl)
        self._rebuild_index()
        self._commit_batch()
        return

    def _splice_span_elements(self, edits) -> None:
        leaves = self.levels[0]
        cum = self._cum_counts()
        is_sorted = self.kind in SORTED_KINDS
        first = min(e[0] for e in edits)
        j0 = min(int(np.searchsorted(cum, first, side="right")), len(leaves) - 1)
        base = int(cum[j0 - 1]) if j0 > 0 else 0
        last_end = max(e[1] for e in edits)
        jE = min(int(np.searchsorted(cum, max(last_end - 1, first),
                                     side="right")), len(leaves) - 1)
        warm, _ = self._warmup_bytes(j0)
        grow = max(2, jE - j0 + 1)
        while True:
            jx = min(jE + grow, len(leaves) - 1)
            old_els: list[bytes] = []
            old_keys: list[bytes] = []
            for j in range(j0, jx + 1):
                els = self.leaf_elements(j)
                if self.kind == ck.MAP:
                    old_els.extend(ck.pack_kv(k, v) for k, v in els)
                    old_keys.extend(k for k, _ in els)
                elif self.kind == ck.SET:
                    old_els.extend(ck.pack_lv(e) for e in els)
                    old_keys.extend(els)
                else:
                    old_els.extend(ck.pack_lv(e) for e in els)
            els_new = list(old_els)
            keys_new = list(old_keys)
            for s, e, reps, rkeys in sorted(edits, key=lambda t: t[0],
                                            reverse=True):
                ls, le = s - base, e - base
                els_new[ls:le] = reps
                if is_sorted:
                    keys_new[ls:le] = rkeys or []
            delta = len(els_new) - len(old_els)
            at_stream_end = jx == len(leaves) - 1
            stream = np.frombuffer(b"".join(els_new), dtype=np.uint8)
            wb = np.frombuffer(warm, dtype=np.uint8)
            bitmap = boundary_bitmap(np.concatenate([wb, stream]),
                                     self.params)[len(wb):]
            lengths = [len(e) for e in els_new]
            cuts = cut_elements(lengths, bitmap, self.params)
            bytecum = np.cumsum([0] + lengths)
            # stability guard in byte space
            stable_el = (last_end - base) + delta
            stable_byte = (int(bytecum[stable_el]) + self.params.window
                           if 0 <= stable_el <= len(lengths) else 1 << 62)
            cumset = {int(c): i + 1 for i, c in enumerate(cum)}
            splice_at = None
            for ci, c in enumerate(cuts[:-1] if not at_stream_end else cuts):
                if c < stable_el or int(bytecum[c]) < stable_byte:
                    continue
                old_idx = c - delta + base
                if old_idx in cumset and old_idx >= last_end:
                    splice_at = (ci, cumset[old_idx])
                    break
            if splice_at is None and not at_stream_end:
                grow *= 2
                continue
            raws, counts, lkeys = [], [], []
            start = 0
            upto = len(cuts) if splice_at is None else splice_at[0] + 1
            for c in cuts[:upto]:
                raws.append(ck.encode_chunk(self.kind,
                                            b"".join(els_new[start:c])))
                counts.append(c - start)
                lkeys.append(keys_new[c - 1] if is_sorted else None)
                start = c
            new_leaves = [Entry(cid, cnt, key) for cid, cnt, key
                          in zip(self._put_chunks(raws), counts, lkeys)]
            tail = leaves[splice_at[1]:] if splice_at else []
            self.levels[0] = leaves[:j0] + new_leaves + tail
            if not self.levels[0]:
                self.levels[0] = self._empty(self.store, self.kind,
                                             self.params).levels[0]
            # invalidate caches; caller rebuilds the index once at the end
            self._cum = None
            self._keycache = None
            self._leaf_cache.clear()
            return

    # ------------------------------------------------------------ diff
    def diff_leaf_blocks(self, other: "POSTree"):
        """Matched/unmatched leaf runs via cid comparison.  Returns
        SequenceMatcher opcodes over leaf-cid sequences — identical-cid
        subtree skipping is what makes Diff O(difference) (paper §4.3)."""
        a = [e.cid for e in self.levels[0]]
        b = [e.cid for e in other.levels[0]]
        sm = SequenceMatcher(a=a, b=b, autojunk=False)
        return sm.get_opcodes()

    def diff_keys(self, other: "POSTree"):
        """Sorted kinds: (added, removed, changed) keys vs `other`
        (self = new, other = old), parsing only differing leaves."""
        if self.kind not in SORTED_KINDS or other.kind != self.kind:
            raise InvariantViolation(
                f"diff_keys needs matching sorted kinds, got {self.kind}/{other.kind}")
        acids = {e.cid for e in self.levels[0]}
        bcids = {e.cid for e in other.levels[0]}
        da = [i for i, e in enumerate(self.levels[0]) if e.cid not in bcids]
        db = [i for i, e in enumerate(other.levels[0]) if e.cid not in acids]
        if self.kind == ck.MAP:
            dicta = {k: v for i in da for k, v in self.leaf_elements(i)}
            dictb = {k: v for i in db for k, v in other.leaf_elements(i)}
        else:
            dicta = {k: b"" for i in da for k in self.leaf_elements(i)}
            dictb = {k: b"" for i in db for k in other.leaf_elements(i)}
        added = sorted(k for k in dicta if k not in dictb)
        removed = sorted(k for k in dictb if k not in dicta)
        changed = sorted(k for k in dicta
                         if k in dictb and dicta[k] != dictb[k])
        return added, removed, changed
