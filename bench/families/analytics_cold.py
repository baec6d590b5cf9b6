"""The cold analytics family: the analytics family's deployment at a size
that outgrows the memory tier, so whole-version reads take most of their
chunks from the segment files (a copy out of the file and a check a
chunk).

Its steps, set-up, judge and the rest of ``finish`` are the analytics
family's (``families/analytics.py``).  Two things differ:

  * ``counters`` adds the segment tier's own ``StoreStats`` as ``"cold"``:
    its gets, its checks and their time, which ``db.store``'s do not hold;
  * the read probe behind ``tamper_undetected`` is two probes, each of
    one leaf's byte range alone, so that neither depends on what the
    memory tier holds when a whole version is read: a leaf of master's
    head altered in the memory tier, and a clean leaf dropped from the
    memory tier and altered at rest in its segment file.  A store that
    stops checking either tier's reads is caught.

It is a family of its own because the analytics family's probes never
read a chunk at rest in a segment file: a store that stopped checking
the chunks it reads from its segment files stayed correct there
(``tests/test_bench_cold.py``).  Its cells' readers of the segment tier
are ``segment_get_ms`` (the program's ``segment.get`` spans) and
``segment_check_ms`` (the ``"cold"`` counters' ``verify_ns``).
"""
from __future__ import annotations

import os

from bench.families import analytics

KEY = analytics.KEY


class Family(analytics.Family):
    # -------------------------------------------------------------- counters
    def counters(self) -> dict:
        out = super().counters()
        out["cold"] = self.db.store.cold.stats.as_dict()
        return out

    # ---------------------------------------------------- after the window
    def _read_probe(self) -> int:
        """The memory tier's probe and the segment files' probe, each 1
        unless its read is refused."""
        return self._hot_probe() + self._cold_probe()

    def _leaves(self):
        """Master's head's leaf entries (cid, count) and their starts."""
        from repro_torch.core import POSTree

        obj = self.db.get(KEY, "master", verify=False).obj
        tree = POSTree.from_root(self.db.store, obj.type, obj.data,
                                 self.db.params)
        leaves = tree.levels[0]
        starts, pos = [], 0
        for e in leaves:
            starts.append(pos)
            pos += e.count
        return leaves, starts

    def _read_range(self, start: int, length: int) -> int:
        """Reads master's bytes [start, start + length) alone; 1 unless the
        read is refused or, unaltered, right."""
        from repro_torch.errors import ReproError

        want = self._bytes_of(self.head["master"])[start:start + length]
        try:
            got = self.db.get(KEY, "master").blob().read(start, length)
        except ReproError:
            return 0
        return int(got != want.tobytes())

    def _hot_probe(self) -> int:
        """Alters the middle leaf of master's head in the memory tier and
        reads that leaf's range back."""
        from repro_torch.errors import ReproError

        store = self.db.store
        try:
            leaves, starts = self._leaves()
            j = len(leaves) // 2
            cid = leaves[j].cid
            store.get(cid)                       # in the memory tier
        except ReproError:
            return 1
        hot = store._hot
        raw = hot[cid]
        hot[cid] = raw[:-1] + bytes([raw[-1] ^ 1])
        try:
            return self._read_range(starts[j], leaves[j].count)
        finally:
            if cid in hot:
                hot[cid] = raw

    def _cold_probe(self) -> int:
        """Drops a clean leaf of master's head (a quarter in) from the
        memory tier, flips its last byte in its segment file at its
        recorded offset, reads that leaf's range back, then puts the byte
        back and drops whatever copy the read promoted."""
        from repro_torch.errors import ReproError

        store = self.db.store
        cold = store.cold
        try:
            leaves, starts = self._leaves()
        except ReproError:
            return 1
        j = next((i for i in range(len(leaves) // 4, len(leaves))
                  if leaves[i].cid not in store._dirty), None)
        if j is None:
            return 1                             # nothing at rest to alter
        cid = leaves[j].cid
        self._drop_hot(cid)
        seg = cold._segments[cold._index[cid]]
        off, ln = seg.live[cid]
        at = off + ln - 1
        fd = os.open(seg.path, os.O_RDWR)
        try:
            byte = os.pread(fd, 1, at)
            os.pwrite(fd, bytes([byte[0] ^ 1]), at)
            try:
                return self._read_range(starts[j], leaves[j].count)
            finally:
                os.pwrite(fd, byte, at)
                self._drop_hot(cid)
        finally:
            os.close(fd)

    def _drop_hot(self, cid: bytes) -> None:
        """Forgets a clean chunk's copy in the memory tier."""
        store = self.db.store
        raw = store._hot.pop(cid, None)
        if raw is not None:
            store._hot_size -= len(raw)
