"""Delta attestations: an incrementally-maintained Merkle tree over the
branch-table head entries (ROADMAP "incremental attestations under
concurrent GC"; UStore shows head-table commitments must be incremental
to serve heavy traffic).

``attest_heads`` re-Merkle-izes all n head entries on every call —
fine for an occasional epoch, ruinous at production attestation rates.
``DeltaAttestor`` keeps the whole tree (sorted entry list + every hash
level) resident and subscribes to branch-table mutation hooks, so an
attest after k head updates re-hashes only the touched leaves' O(log n)
paths:

  * a head *update* (same key, same tag, new uid) never changes the
    entry's sort position — entries are compared by their length-
    prefixed (key, tag) encoding before the uid is reached — so it is
    an in-place leaf replacement: one leaf hash + one path of node
    hashes;
  * an entry *insert/delete* (new branch, removed branch, untagged-head
    churn) shifts positions, so each upper level is recomputed from the
    first changed node — the unchanged prefix of every level is reused
    (appends near the end of the sort order stay O(log n));
  * the first attest, and any attest after the cid hash algorithm was
    swapped (``hashing.set_default_hash``), falls back to ONE full
    rebuild and resumes delta maintenance from there.

The produced ``Attestation`` is bit-identical to ``attest_heads``'s —
verifiers cannot tell (and must not care) how the root was maintained.

Attestation contexts carry the GC collector epoch (``pack_epoch`` /
``attestation_epoch``): the epoch handshake with the incremental
collector (gc.EpochFence) guarantees proofs against an attestation stay
servable until the second collection after its issue begins, so a
verifier can compare the attested epoch with the store's current one to
know whether its anchor is still fresh.
"""
from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass

from .. import obs
from ..core.hashing import current_hash
from .attest import (Attestation, HeadProof, UB_TAG, EMPTY_ROOT,
                     encode_entry, entry_leaves, head_entries, leaf_hash,
                     node_hash, sign)

_EPOCH = struct.Struct("<Q")
EPOCH_MAGIC = b"\xfbE"        # context prefix: epoch-tagged attestation


def pack_epoch(epoch: int, context: bytes = b"") -> bytes:
    """Embed the GC collector epoch into an attestation context."""
    return EPOCH_MAGIC + _EPOCH.pack(epoch) + bytes(context)


def attestation_epoch(att: Attestation) -> int | None:
    """The GC epoch an engine-issued attestation was stamped with, or
    None for a context that does not carry one (foreign attester)."""
    ctx = att.context
    if len(ctx) < len(EPOCH_MAGIC) + 8 or not ctx.startswith(EPOCH_MAGIC):
        return None
    return _EPOCH.unpack_from(ctx, len(EPOCH_MAGIC))[0]


def unpack_epoch(context: bytes) -> bytes:
    """The caller-supplied part of an epoch-tagged context."""
    if context.startswith(EPOCH_MAGIC) and len(context) >= 10:
        return context[len(EPOCH_MAGIC) + 8:]
    return bytes(context)


@dataclass
class DeltaStats:
    leaf_hashes: int = 0      # leaf digests computed (full + delta)
    node_hashes: int = 0      # internal node hashes computed
    full_rebuilds: int = 0    # attests that rebuilt all n leaves
    delta_refreshes: int = 0  # attests served by path updates only
    updates: int = 0          # in-place leaf replacements applied
    inserts: int = 0          # entries added to the tree
    removes: int = 0          # entries dropped from the tree


def _key_entries(branches, key: bytes) -> dict:
    """Current committed entries of one key, keyed so a tagged head
    update (same tag, new uid) pairs with the entry it replaces."""
    out = {}
    tb = branches.tagged(key)
    for tag, uid in tb.items():
        out[("t", tag)] = encode_entry(key, tag, uid)
    aliased = set(tb.values())
    for uid in branches.untagged(key):
        if uid not in aliased:
            out[("u", uid)] = encode_entry(key, UB_TAG, uid)
    return out


class DeltaAttestor:
    """Persistent head-entry Merkle tree over one BranchTable.

    Construction subscribes to the table's mutation hooks; every
    ``attest()`` / ``root()`` first folds the accumulated dirty keys
    into the resident tree and then reads the root in O(1).
    """

    def __init__(self, branches):
        self.branches = branches
        self.stats = DeltaStats()
        self._entries: list[bytes] = []      # global sorted entry list
        self._levels: list[list[bytes]] = [[]]   # [leaf digests, ..., root]
        self._by_key: dict[bytes, dict] = {}     # key -> _key_entries view
        self._dirty: set[bytes] = set()
        self._built = False
        self._hash_fn = None
        branches.add_listener(self._on_mutate)

    # ------------------------------------------------------------ hooks
    def _on_mutate(self, key: bytes) -> None:
        self._dirty.add(bytes(key))

    # ------------------------------------------------------- public api
    def root(self) -> bytes:
        self._refresh()
        if not self._entries:
            return EMPTY_ROOT
        return self._levels[-1][0]

    @property
    def count(self) -> int:
        return len(self._entries)

    def attest(self, context: bytes = b"",
               secret: bytes | None = None) -> Attestation:
        """Bit-identical to ``attest_heads(self.branches, ...)``, at
        O(k log n) hash work for k head changes since the last call."""
        with obs.trace("proof.attest", heads=len(self._entries)):
            obs.inc("attests_total")
            att = Attestation(self.root(), len(self._entries),
                              bytes(context))
            return sign(att, secret) if secret is not None else att

    def prove(self, entry: bytes) -> HeadProof:
        """Audit path for one committed entry straight off the resident
        tree — O(log n) lookup + sibling collection, no re-hashing (the
        per-root proof-cache analogue for head proofs)."""
        self._refresh()
        idx = bisect.bisect_left(self._entries, entry)
        if idx >= len(self._entries) or self._entries[idx] != entry:
            raise KeyError(entry)
        sibs = []
        i = idx
        for level in self._levels[:-1] if len(self._levels) > 1 else []:
            sib = i ^ 1
            if sib < len(level):
                sibs.append(level[sib])
            i //= 2
        return HeadProof(idx, entry, tuple(sibs))

    # -------------------------------------------------------- internals
    def _leaf(self, entry: bytes) -> bytes:
        self.stats.leaf_hashes += 1
        return leaf_hash(entry)

    def _node(self, left: bytes, right: bytes) -> bytes:
        self.stats.node_hashes += 1
        return node_hash(left, right)

    def _refresh(self) -> None:
        cur = current_hash()
        if not self._built or cur is not self._hash_fn:
            self._rebuild()
            self._hash_fn = cur
            return
        if not self._dirty:
            return
        try:
            self._apply_dirty()
        except KeyError:
            # hooks and table diverged (a mutation bypassed the
            # listeners): fall back to one full rebuild — correctness
            # never depends on the delta bookkeeping
            self._rebuild()

    def _apply_dirty(self) -> None:
        self.stats.delta_refreshes += 1
        obs.inc("attest_delta_refreshes_total")
        updates: list[tuple[bytes, bytes]] = []
        inserts: list[bytes] = []
        removes: list[bytes] = []
        for key in sorted(self._dirty):
            new = _key_entries(self.branches, key)
            old = self._by_key.get(key, {})
            if new == old:
                continue
            for slot, e in old.items():
                if slot not in new:
                    removes.append(e)
                elif new[slot] != e:
                    updates.append((e, new[slot]))
            for slot, e in new.items():
                if slot not in old:
                    inserts.append(e)
            if new:
                self._by_key[key] = new
            else:
                self._by_key.pop(key, None)
        self._dirty.clear()
        # 1) in-place replacements: sort position is invariant, so each
        #    is one leaf hash + one root-ward path of node hashes
        for old_e, new_e in updates:
            i = self._find(old_e)
            self._entries[i] = new_e
            self._levels[0][i] = self._leaf(new_e)
            self._update_path(i)
            self.stats.updates += 1
        # 2) structural edits: apply to the leaf level, then recompute
        #    each upper level from its first changed node
        if not (inserts or removes):
            return
        old_lens = [len(level) for level in self._levels]
        first = len(self._entries)
        for e in removes:
            i = self._find(e)
            del self._entries[i]
            del self._levels[0][i]
            first = min(first, i)
            self.stats.removes += 1
        for e in sorted(inserts):
            i = bisect.bisect_left(self._entries, e)
            self._entries.insert(i, e)
            self._levels[0].insert(i, self._leaf(e))
            first = min(first, i)
            self.stats.inserts += 1
        self._recompute_from(first, old_lens)

    def _find(self, entry: bytes) -> int:
        i = bisect.bisect_left(self._entries, entry)
        if i >= len(self._entries) or self._entries[i] != entry:
            raise KeyError(entry)           # hooks and table diverged
        return i

    def _rebuild(self) -> None:
        """Full rebuild (first use / hash-algorithm change): one batched
        leaf-hash dispatch over every entry, levels built bottom-up."""
        self.stats.full_rebuilds += 1
        obs.inc("attest_full_rebuilds_total")
        entries = head_entries(self.branches)
        self._entries = entries
        self.stats.leaf_hashes += len(entries)
        self._levels = [entry_leaves(entries)]
        self._recompute_from(0, [])
        self._by_key = {key: _key_entries(self.branches, key)
                        for key in self.branches.keys()}
        self._by_key = {k: v for k, v in self._by_key.items() if v}
        self._dirty.clear()
        self._built = True

    def _update_path(self, i: int) -> None:
        """Re-hash the root-ward path above an in-place leaf change."""
        for lv in range(1, len(self._levels)):
            child = self._levels[lv - 1]
            p = i // 2
            if 2 * p + 1 < len(child):
                self._levels[lv][p] = self._node(child[2 * p],
                                                 child[2 * p + 1])
            else:                            # odd node promoted
                self._levels[lv][p] = child[2 * p]
            i = p

    def _recompute_from(self, i: int, old_lens: list[int]) -> None:
        """Rebuild the upper levels after leaf inserts/removes starting
        at index ``i``, reusing each level's unchanged prefix.  A node
        is reusable only if it was (and still is) a full pair whose
        children sit strictly below the first changed position — the
        min() guards the odd-promotion edge when level lengths change."""
        lv = 1
        while len(self._levels[lv - 1]) > 1:
            child = self._levels[lv - 1]
            old = self._levels[lv] if lv < len(self._levels) else []
            old_child = old_lens[lv - 1] if lv - 1 < len(old_lens) else 0
            safe = min(i // 2, old_child // 2, len(child) // 2)
            nxt = old[:safe]
            for j in range(safe, (len(child) + 1) // 2):
                if 2 * j + 1 < len(child):
                    nxt.append(self._node(child[2 * j], child[2 * j + 1]))
                else:
                    nxt.append(child[2 * j])
            if lv < len(self._levels):
                self._levels[lv] = nxt
            else:
                self._levels.append(nxt)
            i = safe
            lv += 1
        del self._levels[lv:]


__all__ = ["DeltaAttestor", "DeltaStats", "attestation_epoch",
           "pack_epoch", "unpack_epoch"]
