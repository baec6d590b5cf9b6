"""Built-in data types (paper §3.4).

Primitive types (String, Tuple, Integer) are embedded in the meta chunk and
never deduplicated; chunkable types (Blob, List, Map, Set) are POS-Trees.
Handles buffer edits client-side (piece table / overlay) and flush them as a
single batched incremental commit on Put — matching Fig. 4's programming
model ("changes are buffered in client").  Get returns a handle; leaf data
is fetched lazily, chunk by chunk (§3.4).
"""
from __future__ import annotations

import struct

from . import chunk as ck
from .chunker import ChunkParams, DEFAULT_PARAMS
from .fobject import TINT, TSTRING, TTUPLE
from .pieces import PieceTable
from .postree import POSTree

_I64 = struct.Struct("<q")


# ===================================================================== blobs

class FBlob:
    """Byte-addressable blob: Read / Append / Insert / Remove (Fig. 4)."""

    TYPE = ck.BLOB

    def __init__(self, data: bytes = b"", *, _tree: POSTree | None = None,
                 params: ChunkParams = DEFAULT_PARAMS):
        self.params = params
        self._tree = _tree
        base_len = _tree.total_count if _tree is not None else 0
        self._pt = PieceTable(base_len)
        if data:
            self._pt.splice(0, 0, bytes(data), len(data))

    @classmethod
    def from_tree(cls, tree: POSTree) -> "FBlob":
        return cls(_tree=tree, params=tree.params)

    def __len__(self) -> int:
        return len(self._pt)

    def _base_read(self, s: int, e: int) -> bytes:
        return self._tree.read_bytes(s, e - s) if self._tree is not None else b""

    def read(self, start: int = 0, length: int | None = None) -> bytes:
        end = len(self) if length is None else min(start + length, len(self))
        return self._pt.read(start, end, self._base_read,
                             lambda ps: b"".join(ps))

    def append(self, data: bytes) -> None:
        self._pt.splice(len(self), len(self), bytes(data), len(data))

    def insert(self, pos: int, data: bytes) -> None:
        self._pt.splice(pos, pos, bytes(data), len(data))

    def remove(self, pos: int, length: int) -> None:
        self._pt.splice(pos, min(pos + length, len(self)), b"", 0)

    def replace(self, pos: int, length: int, data: bytes) -> None:
        self._pt.splice(pos, min(pos + length, len(self)), bytes(data),
                        len(data))

    def commit(self, store) -> bytes:
        """Flush buffered edits; returns the POS-Tree root cid."""
        if self._tree is None:
            self._tree = POSTree.build_bytes(store, self.read(), self.params)
        elif self._pt.dirty:
            edits = self._pt.base_edits(lambda ps: b"".join(ps))
            self._tree.splice_bytes(edits, sink=store)
        self._pt = PieceTable(self._tree.total_count)
        return self._tree.root_cid

    @property
    def tree(self) -> POSTree | None:
        return self._tree


# ===================================================================== lists

class FList:
    """Positional element list."""

    TYPE = ck.LIST

    def __init__(self, elements: list[bytes] | None = None, *,
                 _tree: POSTree | None = None,
                 params: ChunkParams = DEFAULT_PARAMS):
        self.params = params
        self._tree = _tree
        base_len = _tree.total_count if _tree is not None else 0
        self._pt = PieceTable(base_len)
        if elements:
            els = [bytes(e) for e in elements]
            self._pt.splice(0, 0, els, len(els))

    @classmethod
    def from_tree(cls, tree: POSTree) -> "FList":
        return cls(_tree=tree, params=tree.params)

    def __len__(self) -> int:
        return len(self._pt)

    def _base_read(self, s: int, e: int) -> list[bytes]:
        return [self._tree.get_item(i) for i in range(s, e)]

    def get(self, i: int) -> bytes:
        return self._pt.read(i, i + 1, self._base_read,
                             lambda ps: [x for p in ps for x in p])[0]

    def slice(self, s: int, e: int) -> list[bytes]:
        return self._pt.read(s, min(e, len(self)), self._base_read,
                             lambda ps: [x for p in ps for x in p])

    def set(self, i: int, v: bytes) -> None:
        self._pt.splice(i, i + 1, [bytes(v)], 1)

    def insert(self, i: int, v: bytes) -> None:
        self._pt.splice(i, i, [bytes(v)], 1)

    def append(self, v: bytes) -> None:
        self._pt.splice(len(self), len(self), [bytes(v)], 1)

    def extend(self, vs: list[bytes]) -> None:
        vs = [bytes(v) for v in vs]
        self._pt.splice(len(self), len(self), vs, len(vs))

    def delete(self, i: int, n: int = 1) -> None:
        self._pt.splice(i, min(i + n, len(self)), [], 0)

    def __iter__(self):
        return iter(self.slice(0, len(self)))

    def commit(self, store) -> bytes:
        if self._tree is None:
            els = [ck.pack_lv(e) for e in self.slice(0, len(self))]
            self._tree = POSTree.build_elements(store, ck.LIST, els,
                                                params=self.params)
        elif self._pt.dirty:
            raw_edits = self._pt.base_edits(
                lambda ps: [x for p in ps for x in p])
            edits = [(s, e, [ck.pack_lv(x) for x in rep], None)
                     for s, e, rep in raw_edits]
            self._tree.splice_elements(edits, sink=store)
        self._pt = PieceTable(self._tree.total_count)
        return self._tree.root_cid

    @property
    def tree(self) -> POSTree | None:
        return self._tree


# ================================================================== map/set

_DEL = object()


class FMap:
    """Sorted key->value map; overlay-buffered edits."""

    TYPE = ck.MAP

    def __init__(self, items: dict[bytes, bytes] | None = None, *,
                 _tree: POSTree | None = None,
                 params: ChunkParams = DEFAULT_PARAMS):
        self.params = params
        self._tree = _tree
        self._ov: dict[bytes, object] = {}
        if items:
            for k, v in items.items():
                self._ov[bytes(k)] = bytes(v)

    @classmethod
    def from_tree(cls, tree: POSTree) -> "FMap":
        return cls(_tree=tree, params=tree.params)

    def get(self, k: bytes) -> bytes | None:
        k = bytes(k)
        if k in self._ov:
            v = self._ov[k]
            return None if v is _DEL else v  # type: ignore[return-value]
        if self._tree is None:
            return None
        found, j, li, gi = self._tree.find_key(k)
        return self._tree.get_item(gi)[1] if found else None

    def set(self, k: bytes, v: bytes) -> None:
        self._ov[bytes(k)] = bytes(v)

    def update(self, items) -> None:
        for k, v in (items.items() if isinstance(items, dict) else items):
            self._ov[bytes(k)] = bytes(v)

    def delete(self, k: bytes) -> None:
        self._ov[bytes(k)] = _DEL

    def items(self):
        """Sorted merged iteration (tree + overlay)."""
        ovkeys = sorted(self._ov)
        oi = 0
        if self._tree is not None:
            for k, v in self._tree.iter_elements():
                while oi < len(ovkeys) and ovkeys[oi] < k:
                    ov = self._ov[ovkeys[oi]]
                    if ov is not _DEL:
                        yield ovkeys[oi], ov
                    oi += 1
                if oi < len(ovkeys) and ovkeys[oi] == k:
                    ov = self._ov[ovkeys[oi]]
                    if ov is not _DEL:
                        yield k, ov
                    oi += 1
                else:
                    yield k, v
        while oi < len(ovkeys):
            ov = self._ov[ovkeys[oi]]
            if ov is not _DEL:
                yield ovkeys[oi], ov
            oi += 1

    def __len__(self) -> int:
        n = self._tree.total_count if self._tree is not None else 0
        for k, v in self._ov.items():
            if self._tree is not None:
                found, *_ = self._tree.find_key(k)
            else:
                found = False
            if v is _DEL:
                n -= 1 if found else 0
            else:
                n += 0 if found else 1
        return n

    def commit(self, store) -> bytes:
        if self._tree is None:
            items = sorted((k, v) for k, v in self._ov.items()
                           if v is not _DEL)
            els = [ck.pack_kv(k, v) for k, v in items]
            keys = [k for k, _ in items]
            self._tree = POSTree.build_elements(store, ck.MAP, els, keys,
                                                self.params)
        elif len(self._ov) * 4 >= self._tree.total_count:
            # epoch-fold fast path (live tables): when the delta
            # dominates the tree, per-key find_key + clustered splice
            # costs more than streaming the sorted merge of tree and
            # overlay straight through build_elements — one put_many
            # for all leaves, one content_hash_many dispatch per index
            # level.  Node boundaries are a function of content alone,
            # so the root is bit-identical to the splice path's.
            items = list(self.items())
            els = [ck.pack_kv(k, v) for k, v in items]
            keys = [k for k, _ in items]
            self._tree = POSTree.build_elements(store, ck.MAP, els, keys,
                                                self.params)
        elif self._ov:
            edits = []
            for k in sorted(self._ov):
                v = self._ov[k]
                found, j, li, gi = self._tree.find_key(k)
                if v is _DEL:
                    if found:
                        edits.append((gi, gi + 1, [], []))
                elif found:
                    if self._tree.get_item(gi)[1] != v:
                        edits.append((gi, gi + 1, [ck.pack_kv(k, v)], [k]))
                else:
                    edits.append((gi, gi, [ck.pack_kv(k, v)], [k]))
            edits = _coalesce(edits)
            if edits:
                self._tree.splice_elements(edits, sink=store)
        self._ov = {}
        return self._tree.root_cid

    @property
    def tree(self) -> POSTree | None:
        return self._tree


class FSet:
    TYPE = ck.SET

    def __init__(self, items=None, *, _tree: POSTree | None = None,
                 params: ChunkParams = DEFAULT_PARAMS):
        self.params = params
        self._tree = _tree
        self._ov: dict[bytes, bool] = {}  # True=add, False=remove
        for it in items or []:
            self._ov[bytes(it)] = True

    @classmethod
    def from_tree(cls, tree: POSTree) -> "FSet":
        return cls(_tree=tree, params=tree.params)

    def contains(self, k: bytes) -> bool:
        k = bytes(k)
        if k in self._ov:
            return self._ov[k]
        if self._tree is None:
            return False
        found, *_ = self._tree.find_key(k)
        return found

    def add(self, k: bytes) -> None:
        self._ov[bytes(k)] = True

    def remove(self, k: bytes) -> None:
        self._ov[bytes(k)] = False

    def __iter__(self):
        ovkeys = sorted(self._ov)
        oi = 0
        if self._tree is not None:
            for k in self._tree.iter_elements():
                while oi < len(ovkeys) and ovkeys[oi] < k:
                    if self._ov[ovkeys[oi]]:
                        yield ovkeys[oi]
                    oi += 1
                if oi < len(ovkeys) and ovkeys[oi] == k:
                    if self._ov[ovkeys[oi]]:
                        yield k
                    oi += 1
                else:
                    yield k
        while oi < len(ovkeys):
            if self._ov[ovkeys[oi]]:
                yield ovkeys[oi]
            oi += 1

    def commit(self, store) -> bytes:
        if self._tree is None:
            items = sorted(k for k, add in self._ov.items() if add)
            els = [ck.pack_lv(k) for k in items]
            self._tree = POSTree.build_elements(store, ck.SET, els, items,
                                                self.params)
        elif self._ov:
            edits = []
            for k in sorted(self._ov):
                add = self._ov[k]
                found, j, li, gi = self._tree.find_key(k)
                if add and not found:
                    edits.append((gi, gi, [ck.pack_lv(k)], [k]))
                elif not add and found:
                    edits.append((gi, gi + 1, [], []))
            edits = _coalesce(edits)
            if edits:
                self._tree.splice_elements(edits, sink=store)
        self._ov = {}
        return self._tree.root_cid

    @property
    def tree(self) -> POSTree | None:
        return self._tree


def _coalesce(edits):
    """Merge adjacent/same-position element edits into non-overlapping,
    sorted splices (find_key indices may collide for consecutive inserts)."""
    if not edits:
        return edits
    edits.sort(key=lambda t: (t[0], t[1]))
    out = [list(edits[0])]
    for s, e, reps, keys in edits[1:]:
        ps, pe, preps, pkeys = out[-1]
        if s <= pe:  # adjacent or same position: merge
            out[-1] = [ps, max(pe, e), preps + reps,
                       (pkeys or []) + (keys or []) if pkeys is not None
                       or keys is not None else None]
        else:
            out.append([s, e, reps, keys])
    return [tuple(x) for x in out]


# ================================================================ primitives

class FString:
    TYPE = TSTRING

    def __init__(self, value: bytes = b""):
        self.value = bytes(value)

    def append(self, data: bytes) -> None:
        self.value += bytes(data)

    def insert(self, pos: int, data: bytes) -> None:
        self.value = self.value[:pos] + bytes(data) + self.value[pos:]

    def encode(self) -> bytes:
        return self.value

    @classmethod
    def decode(cls, data: bytes) -> "FString":
        return cls(data)


class FTuple:
    TYPE = TTUPLE

    def __init__(self, fields: list[bytes] | None = None):
        self.fields = [bytes(f) for f in (fields or [])]

    def append(self, f: bytes) -> None:
        self.fields.append(bytes(f))

    def insert(self, i: int, f: bytes) -> None:
        self.fields.insert(i, bytes(f))

    def get(self, i: int) -> bytes:
        return self.fields[i]

    def set(self, i: int, f: bytes) -> None:
        self.fields[i] = bytes(f)

    def encode(self) -> bytes:
        return b"".join(ck.pack_lv(f) for f in self.fields)

    @classmethod
    def decode(cls, data: bytes) -> "FTuple":
        return cls(ck.unpack_lv_stream(data))


class FInt:
    TYPE = TINT

    def __init__(self, value: int = 0):
        self.value = int(value)

    def add(self, x: int) -> None:
        self.value += x

    def multiply(self, x: int) -> None:
        self.value *= x

    def encode(self) -> bytes:
        return _I64.pack(self.value)

    @classmethod
    def decode(cls, data: bytes) -> "FInt":
        return cls(_I64.unpack(data)[0])


PRIMITIVE_CLASSES = {TSTRING: FString, TTUPLE: FTuple, TINT: FInt}
CHUNKABLE_CLASSES = {ck.BLOB: FBlob, ck.LIST: FList, ck.MAP: FMap,
                     ck.SET: FSet}
