"""Three-way merge + conflict resolution (paper §3.3.3, §4.5.2).

Merge(v1, v2) feeds (v1, v2, LCA(v1, v2)) into a type-specific merge
function.  On conflicts it returns a conflict list; built-in resolvers
(append, aggregate, choose_one) or a user hook may resolve them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import chunk as ck
from ..errors import MergeConflict
from .fobject import TINT, load_fobject
from .postree import POSTree
from .types import (FInt, FMap, FSet)

__all__ = ["Conflict", "MergeConflict", "merge"]


@dataclass(frozen=True)
class Conflict:
    where: object          # key (Map/Set), (start,end) range, or None
    base: object
    ours: object
    theirs: object


# ------------------------------------------------------------- resolvers

def choose_one(side: int = 0) -> Callable:
    def fn(c: Conflict):
        return c.ours if side == 0 else c.theirs
    return fn


def append_resolver(c: Conflict):
    ours = c.ours if c.ours is not None else b""
    theirs = c.theirs if c.theirs is not None else b""
    return ours + theirs


def aggregate_resolver(c: Conflict):
    """Numeric: base + (ours-base) + (theirs-base)."""
    return c.ours + c.theirs - c.base


BUILTIN_RESOLVERS = {"choose_ours": choose_one(0),
                     "choose_theirs": choose_one(1),
                     "append": append_resolver,
                     "aggregate": aggregate_resolver}


# ----------------------------------------------------------- LCA (M17)

def lca(store, uid1: bytes, uid2: bytes) -> bytes | None:
    """Least common ancestor on the derivation DAG (M17): pop frontier nodes
    in decreasing depth (versions carry depth, Fig. 2), propagating which
    side(s) reach each node; the first node popped that both sides reach is
    a deepest common ancestor."""
    import heapq

    if uid1 == uid2:
        return uid1
    seen = {uid1: 1, uid2: 2}
    heap = [(-load_fobject(store, uid1).depth, uid1),
            (-load_fobject(store, uid2).depth, uid2)]
    heapq.heapify(heap)
    while heap:
        _, u = heapq.heappop(heap)
        mask = seen[u]
        if mask == 3:
            return u
        for b in load_fobject(store, u).bases:
            old = seen.get(b, 0)
            if old | mask != old:
                seen[b] = old | mask
                heapq.heappush(heap, (-load_fobject(store, b).depth, b))
    return None


# ----------------------------------------------------- type-specific merges

def merge_map(store, base: FMap | None, ours: FMap, theirs: FMap,
              resolver=None) -> FMap:
    bt = base.tree if base is not None else None
    conflicts, edits = [], {}
    if bt is None:
        ochg = {k: v for k, v in ours.items()}
        tchg = {k: v for k, v in theirs.items()}
        allk = set(ochg) | set(tchg)
        for k in allk:
            ov, tv = ochg.get(k), tchg.get(k)
            if ov == tv:
                edits[k] = ov
            elif ov is None:
                edits[k] = tv
            elif tv is None:
                edits[k] = ov
            else:
                conflicts.append(Conflict(k, None, ov, tv))
    else:
        oa, orm, och = ours.tree.diff_keys(bt)
        ta, trm, tch = theirs.tree.diff_keys(bt)
        ochange = {k: ("add", ours.get(k)) for k in oa}
        ochange.update({k: ("del", None) for k in orm})
        ochange.update({k: ("chg", ours.get(k)) for k in och})
        tchange = {k: ("add", theirs.get(k)) for k in ta}
        tchange.update({k: ("del", None) for k in trm})
        tchange.update({k: ("chg", theirs.get(k)) for k in tch})
        for k in set(ochange) | set(tchange):
            oc, tc = ochange.get(k), tchange.get(k)
            if oc is not None and tc is not None and oc != tc:
                conflicts.append(Conflict(k, base.get(k),
                                          oc[1], tc[1]))
            else:
                op, val = oc or tc
                edits[k] = None if op == "del" else val
    if conflicts:
        if resolver is None:
            raise MergeConflict(conflicts)
        for c in conflicts:
            edits[c.where] = resolver(c)
    # materialize merged = ours + theirs' (resolved) changes
    merged = FMap.from_tree(ours.tree) if ours.tree is not None else FMap()
    for k, v in edits.items():
        if v is None:
            merged.delete(k)
        else:
            merged.set(k, v)
    merged.commit(store)
    return merged


def merge_set(store, base: FSet | None, ours: FSet, theirs: FSet,
              resolver=None) -> FSet:
    bt = base.tree if base is not None else None
    bkeys = set(bt.iter_elements()) if bt is not None else set()
    okeys, tkeys = set(iter(ours)), set(iter(theirs))
    merged_keys = (okeys & tkeys) | (okeys - bkeys) | (tkeys - bkeys)
    # removed by either side stays removed unless re-added by the other
    out = FSet(sorted(merged_keys))
    out.commit(store)
    return out


def _changed_ranges(base: POSTree, side: POSTree):
    """Base item-ranges altered by `side`, with replacement items.
    Leaf-cid SequenceMatcher opcodes locate the changed chunk runs in
    O(difference); each run is then refined to item granularity by trimming
    the common prefix/suffix, so merge conflicts are per-item, not
    per-chunk."""
    bcum = np.concatenate([[0], np.cumsum([e.count for e in base.levels[0]])])
    scum = np.concatenate([[0], np.cumsum([e.count for e in side.levels[0]])])
    out = []
    for tag, i1, i2, j1, j2 in base.diff_leaf_blocks(side):
        if tag == "equal":
            continue
        bs, be = int(bcum[i1]), int(bcum[i2])
        js, je = int(scum[j1]), int(scum[j2])
        bi = _items_range(base, bs, be)
        si = _items_range(side, js, je)
        pre = 0
        while pre < len(bi) and pre < len(si) and bi[pre] == si[pre]:
            pre += 1
        suf = 0
        while (suf < len(bi) - pre and suf < len(si) - pre
               and bi[len(bi) - 1 - suf] == si[len(si) - 1 - suf]):
            suf += 1
        if pre == len(bi) == len(si):
            continue
        out.append((bs + pre, be - suf, js + pre, je - suf))
    return out


def _items_range(tree: POSTree, s: int, e: int):
    if tree.kind == ck.BLOB:
        return tree.read_bytes(s, e - s)
    return [tree.get_item(i) for i in range(s, e)]


def merge_linear(store, kind: int, base: POSTree | None, ours: POSTree,
                 theirs: POSTree, resolver=None, params=None):
    """Blob/List 3-way region merge: disjoint edited base-ranges compose;
    overlapping ranges conflict."""
    if base is None:
        raise MergeConflict([Conflict(None, None, ours.root_cid,
                                      theirs.root_cid)])
    ro = _changed_ranges(base, ours)
    rt = _changed_ranges(base, theirs)
    conflicts = []
    for (bs, be, *_ ) in ro:
        for (cs, ce, *_ ) in rt:
            if bs < ce and cs < be:   # overlap in base coords
                conflicts.append(Conflict(
                    (max(bs, cs), min(be, ce)),
                    _items_range(base, max(bs, cs), min(be, ce)),
                    None, None))
    if conflicts and resolver is None:
        raise MergeConflict(conflicts)
    # rebuild: walk base, applying both sides' replacements
    edits = ([(bs, be, ("o", js, je)) for bs, be, js, je in ro] +
             [(bs, be, ("t", js, je)) for bs, be, js, je in rt])
    edits.sort()
    pieces = []
    cursor = 0
    skip_until = -1
    for bs, be, (side, js, je) in edits:
        if bs < skip_until:       # overlapped & resolved: ours wins region
            continue
        pieces.append(_items_range(base, cursor, bs))
        src = ours if side == "o" else theirs
        pieces.append(_items_range(src, js, je))
        cursor = be
        skip_until = be
    pieces.append(_items_range(base, cursor, base.total_count))
    if kind == ck.BLOB:
        data = b"".join(bytes(p) for p in pieces)
        return POSTree.build_bytes(store, data,
                                   params or base.params)
    els = [ck.pack_lv(x) for p in pieces for x in p]
    return POSTree.build_elements(store, ck.LIST, els,
                                  params=params or base.params)


def merge_primitive(type_: int, base_data: bytes | None, ours: bytes,
                    theirs: bytes, resolver=None) -> bytes:
    if ours == theirs:
        return ours
    if base_data is not None:
        if ours == base_data:
            return theirs
        if theirs == base_data:
            return ours
    c = Conflict(None, base_data, ours, theirs)
    if resolver is None:
        raise MergeConflict([c])
    if resolver is aggregate_resolver and type_ == TINT:
        b = FInt.decode(base_data or FInt(0).encode()).value
        o, t = FInt.decode(ours).value, FInt.decode(theirs).value
        return FInt(o + t - b).encode()
    return resolver(c)
