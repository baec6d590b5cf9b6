"""Branch management (paper §4.5): per-key TB-table (tagged branches:
name -> head uid) and UB-table (untagged branch heads = leaves of the
object derivation graph)."""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..errors import BranchExists, GuardFailed, NoSuchRef

DEFAULT_BRANCH = "master"

__all__ = ["BranchExists", "BranchTable", "DEFAULT_BRANCH",
           "GuardFailed", "KeyBranches", "NoSuchRef"]


@dataclass
class KeyBranches:
    tb: dict[str, bytes] = field(default_factory=dict)   # tag -> head uid
    ub: set[bytes] = field(default_factory=set)          # DAG leaf uids
    foc: set[bytes] = field(default_factory=set)  # genuine FoC racing heads


class BranchTable:
    """One per servlet; serializes concurrent updates per key (§4.5.1)."""

    def __init__(self):
        self._keys: dict[bytes, KeyBranches] = {}
        self._listeners: list = []
        # incremental head refcounts: uid -> number of (key, tag) slots
        # plus UB memberships pointing at it.  all_heads() — hammered by
        # every attest() and every GC root snapshot — reads this instead
        # of walking the whole table.
        self._head_rc: dict[bytes, int] = {}

    # ---- mutation hooks (delta attestations) ----
    def add_listener(self, fn) -> None:
        """Register ``fn(key)`` to fire after any head-state mutation of
        that key — the dirty-key feed for incremental attestations."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _touch(self, key: bytes) -> None:
        for fn in self._listeners:
            fn(key)

    def _inc(self, uid: bytes) -> None:
        self._head_rc[uid] = self._head_rc.get(uid, 0) + 1

    def _dec(self, uid: bytes) -> None:
        n = self._head_rc.get(uid, 0) - 1
        if n > 0:
            self._head_rc[uid] = n
        else:
            self._head_rc.pop(uid, None)

    def of(self, key: bytes) -> KeyBranches:
        return self._keys.setdefault(bytes(key), KeyBranches())

    def known(self, key: bytes) -> bool:
        return bytes(key) in self._keys

    def keys(self) -> list[bytes]:
        return sorted(self._keys)

    # ---- update rules (§4.5.1) ----
    def on_new_version(self, key: bytes, uid: bytes,
                       bases: tuple[bytes, ...], *,
                       foc: bool = False) -> None:
        """UB-table: add the new head, retire its bases.  A base not present
        means it was already derived -> implicit fork (FoC) keeps both.
        ``foc=True`` marks the head as a *genuine* fork-on-conflict head
        (created against an explicit base version, or by merging untagged
        heads): such heads are live in their own right, independent of
        any tag that may later alias them — remove() consults this."""
        kb = self.of(key)
        for b in bases:
            if b in kb.ub:
                kb.ub.discard(b)
                self._dec(b)
            kb.foc.discard(b)       # derived from -> no longer a leaf
        if uid not in kb.ub:
            kb.ub.add(uid)
            self._inc(uid)
        if foc:
            kb.foc.add(uid)
        self._touch(bytes(key))

    def set_head(self, key: bytes, branch: str, uid: bytes,
                 guard: bytes | None = None) -> None:
        kb = self.of(key)
        if guard is not None and kb.tb.get(branch) != guard:
            raise GuardFailed(branch)
        old = kb.tb.get(branch)
        if old is not None:
            self._dec(old)
        kb.tb[branch] = uid
        self._inc(uid)
        self._touch(bytes(key))

    def head(self, key: bytes, branch: str) -> bytes | None:
        return self.of(key).tb.get(branch)

    def fork(self, key: bytes, new_branch: str, uid: bytes) -> None:
        kb = self.of(key)
        if new_branch in kb.tb:
            raise BranchExists(new_branch)
        kb.tb[new_branch] = uid
        self._inc(uid)
        self._touch(bytes(key))

    def rename(self, key: bytes, old: str, new: str) -> None:
        kb = self.of(key)
        if new in kb.tb:
            raise BranchExists(new)
        if old not in kb.tb:
            raise NoSuchRef(old)
        kb.tb[new] = kb.tb.pop(old)
        self._touch(bytes(key))

    def remove(self, key: bytes, branch: str) -> None:
        """Drop the tagged branch; its head also leaves the UB table, so
        the detached line of development becomes collectable by GC —
        UNLESS the head is live independently of this tag: another tag
        still points at it, or it is a genuine fork-on-conflict racing
        head (``foc``), which a tag only ever *aliased* — removing the
        alias restores the pre-tag state regardless of removal order."""
        kb = self.of(key)
        uid = kb.tb.pop(branch, None)
        if uid is not None:
            self._dec(uid)
            if (uid not in kb.foc and uid not in kb.tb.values()
                    and uid in kb.ub):
                kb.ub.discard(uid)
                self._dec(uid)
            self._touch(bytes(key))

    def tagged(self, key: bytes) -> dict[str, bytes]:
        return dict(self.of(key).tb)

    def untagged(self, key: bytes) -> list[bytes]:
        return sorted(self.of(key).ub)

    def all_heads(self) -> set[bytes]:
        """Every live head across all keys — the GC root set (TB + UB).
        Served from the incremental refcounts: O(distinct heads), not
        O(keys x branches)."""
        return set(self._head_rc)

    def heads_of(self, key: bytes) -> set[bytes]:
        """Live heads (TB + UB) of ONE key — the per-key slice of
        ``all_heads`` the delta attest path pins for a dirty key, so an
        attest after k head changes pins O(k) uids instead of
        O(all heads)."""
        kb = self._keys.get(bytes(key))
        if kb is None:
            return set()
        return set(kb.tb.values()) | kb.ub

    # ---- durable head persistence (storage.durable) ----
    def snapshot(self) -> bytes:
        """Canonical serialization of the full head state (TB + UB +
        foc), byte-identical for identical state — the unit the durable
        engine persists with ``write_durably`` on every ``sync()``."""
        doc = {k.hex(): {"tb": {n: u.hex() for n, u in kb.tb.items()},
                         "ub": sorted(u.hex() for u in kb.ub),
                         "foc": sorted(u.hex() for u in kb.foc)}
               for k, kb in sorted(self._keys.items())}
        return json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()

    def restore(self, blob: bytes) -> None:
        """Load a ``snapshot()`` into this (empty, freshly constructed)
        table, rebuilding the incremental head refcounts.  Listeners are
        not fired: restoring is reopening, not mutating."""
        doc = json.loads(blob)
        for khex, d in doc.items():
            kb = self.of(bytes.fromhex(khex))
            for name, uhex in d["tb"].items():
                uid = bytes.fromhex(uhex)
                kb.tb[name] = uid
                self._inc(uid)
            for uhex in d["ub"]:
                uid = bytes.fromhex(uhex)
                kb.ub.add(uid)
                self._inc(uid)
            kb.foc.update(bytes.fromhex(u) for u in d["foc"])
