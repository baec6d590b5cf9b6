"""PinSet — explicit GC roots for state the branch tables can't see.

Two users:
  * in-flight readers: a long scan holds the uid it is walking so a
    concurrent ``collect()`` can't sweep chunks out from under it;
  * checkpoint retention holds: ``CheckpointStore.prune`` pins versions
    an external consumer (eval job, export) still needs even though the
    retention policy would retire them.

Pins are reference-counted, so nested holds of the same uid compose.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager


class PinSet:
    def __init__(self, on_pin=None):
        self._refs: Counter[bytes] = Counter()
        # root barrier for incremental GC: pinning a detached uid while
        # a collection is in flight must shade/rescue it (the engine
        # wires this to its active collectors)
        self.on_pin = on_pin

    def pin(self, *uids: bytes) -> None:
        for u in uids:
            self._refs[bytes(u)] += 1
            if self.on_pin is not None:
                self.on_pin(bytes(u))

    def unpin(self, *uids: bytes) -> None:
        for u in uids:
            u = bytes(u)
            if self._refs[u] <= 1:
                del self._refs[u]
            else:
                self._refs[u] -= 1

    @contextmanager
    def hold(self, *uids: bytes):
        """Scoped pin for an in-flight reader."""
        self.pin(*uids)
        try:
            yield
        finally:
            self.unpin(*uids)

    def uids(self) -> set[bytes]:
        return set(self._refs)

    def __contains__(self, uid: bytes) -> bool:
        return bytes(uid) in self._refs

    def __len__(self) -> int:
        return len(self._refs)
