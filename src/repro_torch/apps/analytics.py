"""Collaborative analytics (paper §5.3, §6.4): versioned relational
datasets on ForkBase — row and column layouts — vs an OrpheusDB-style
version-vector baseline.

ForkBase layouts:
  * row-oriented:    Map pk -> Tuple-packed record (good for point ops);
  * column-oriented: one List per column under "<ds>/<col>" (aggregations
    touch only the queried column's chunks — Fig. 17b's 10x gap).

OrpheusDB baseline: a shared append-only record heap + one rid-vector per
dataset version (checkout materializes, commit appends new records + a
full new vector; version diff compares full vectors — Fig. 16/17a).
"""
from __future__ import annotations

import struct

from ..core import FList, FMap, FTuple, ForkBase

_I64 = struct.Struct("<q")


def pack_record(fields: list[bytes]) -> bytes:
    return FTuple(fields).encode()


def unpack_record(data: bytes) -> list[bytes]:
    return FTuple.decode(data).fields


# =============================================================== ForkBase

class RowTable:
    """Row layout: Map pk -> packed record, one ForkBase key per dataset."""

    def __init__(self, db: ForkBase, name: str, branch: str = "master"):
        self.db = db
        self.name = name
        self.branch = branch

    def load(self, records: dict[bytes, list[bytes]]) -> bytes:
        m = FMap({pk: pack_record(f) for pk, f in records.items()})
        return self.db.put(self.name, m, self.branch)

    def checkout(self) -> FMap:
        return self.db.get(self.name, self.branch).map()

    def update(self, updates: dict[bytes, list[bytes]]) -> bytes:
        m = self.checkout()            # handle only — chunks fetched lazily
        for pk, fields in updates.items():
            m.set(pk, pack_record(fields))
        return self.db.put(self.name, m, self.branch)

    def get(self, pk: bytes) -> list[bytes]:
        v = self.checkout().get(pk)
        return unpack_record(v) if v is not None else None

    def aggregate(self, field_idx: int) -> int:
        """Sum an integer field across all records (full row scan)."""
        total = 0
        for _, v in self.checkout().items():
            total += int(unpack_record(v)[field_idx])
        return total

    def diff(self, uid1: bytes, uid2: bytes):
        return self.db.diff(uid1, uid2)

    def fork(self, new_branch: str) -> None:
        self.db.fork(self.name, self.branch, new_branch)


class ColumnTable:
    """Column layout: one List per column."""

    def __init__(self, db: ForkBase, name: str, columns: list[str],
                 branch: str = "master"):
        self.db = db
        self.name = name
        self.columns = columns
        self.branch = branch

    def _key(self, col: str) -> str:
        return f"{self.name}/{col}"

    def load(self, rows: list[list[bytes]]) -> None:
        for ci, col in enumerate(self.columns):
            l = FList([r[ci] for r in rows])
            self.db.put(self._key(col), l, self.branch)

    def update_rows(self, updates: dict[int, list[bytes]]) -> None:
        for ci, col in enumerate(self.columns):
            l = self.db.get(self._key(col), self.branch).list()
            for ridx, fields in updates.items():
                l.set(ridx, fields[ci])
            self.db.put(self._key(col), l, self.branch)

    def aggregate(self, col: str) -> int:
        """Sum an integer column: touches only this column's chunks."""
        l = self.db.get(self._key(col), self.branch).list()
        return sum(int(v) for v in l)

    def fork(self, new_branch: str) -> None:
        for col in self.columns:
            self.db.fork(self._key(col), self.branch, new_branch)


# =============================================================== OrpheusDB

class OrpheusLite:
    """Version-vector dataset store in the OrpheusDB style: shared record
    heap + rid array per version."""

    def __init__(self):
        self.heap: list[bytes] = []          # append-only records
        self.versions: dict[int, list[int]] = {}
        self._next = 0
        self.storage_bytes = 0

    def load(self, records: list[list[bytes]]) -> int:
        rids = []
        for r in records:
            self.heap.append(pack_record(r))
            self.storage_bytes += len(self.heap[-1])
            rids.append(len(self.heap) - 1)
        return self._new_version(rids)

    def _new_version(self, rids: list[int]) -> int:
        vid = self._next
        self._next += 1
        self.versions[vid] = rids
        self.storage_bytes += 8 * len(rids)   # the version's rid vector
        return vid

    def checkout(self, vid: int) -> list[list[bytes]]:
        """Materialize a working copy (the paper notes this full
        reconstruction is what makes OrpheusDB checkouts slow)."""
        return [unpack_record(self.heap[r]) for r in self.versions[vid]]

    def commit(self, vid: int, updates: dict[int, list[bytes]]) -> int:
        rids = list(self.versions[vid])
        for ridx, fields in updates.items():
            self.heap.append(pack_record(fields))
            self.storage_bytes += len(self.heap[-1])
            rids[ridx] = len(self.heap) - 1
        return self._new_version(rids)

    def diff(self, v1: int, v2: int) -> list[int]:
        """Full vector comparison (paper §6.4.2)."""
        a, b = self.versions[v1], self.versions[v2]
        return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]

    def aggregate(self, vid: int, field_idx: int) -> int:
        return sum(int(unpack_record(self.heap[r])[field_idx])
                   for r in self.versions[vid])
