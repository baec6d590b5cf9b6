"""LOCK001 / LOCK002 — static lock-order and blocking-under-lock checks.

Lock identity is resolved purely by attribute name: every ranked lock in
the tree has a repo-unique attribute name registered in
``repro_torch.core.locking.LOCK_ATTRS`` (the single source of truth — this
module imports it, never copies it).  That convention is what makes the
analysis sound without type inference; unranked leaf mutexes must be
named ``*mutex*`` (NOT ``*lock*``) and must never wrap other
acquisitions.
"""
from __future__ import annotations

import ast

from ..core.locking import LOCK_ATTRS, LOCK_ORDER

__all__ = ["check_blocking_under_lock", "check_lock_order"]


def _lock_name(expr: ast.expr) -> str | None:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _rank_of(expr: ast.expr) -> tuple[str, int] | None:
    name = _lock_name(expr)
    if name in LOCK_ATTRS:
        rank_name = LOCK_ATTRS[name]
        return rank_name, LOCK_ORDER[rank_name]
    return None


def _is_lockish(expr: ast.expr) -> bool:
    name = _lock_name(expr)
    return name is not None and "lock" in name.lower()


# ---------------------------------------------------------------- LOCK001

def check_lock_order(path, tree, lines):
    findings = []

    def walk(node, held):
        # a nested def is a new execution context: its body does not run
        # while the enclosing with-block's locks are (necessarily) held
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for child in ast.iter_child_nodes(node):
                walk(child, [])
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                ce = item.context_expr
                ranked = _rank_of(ce)
                if ranked is not None:
                    rname, rank = ranked
                    for hname, hrank, _ in held:
                        if rank < hrank:
                            findings.append((
                                "LOCK001", ce.lineno, ce.col_offset,
                                f"acquires {rname} lock (rank {rank}) while "
                                f"holding {hname} lock (rank {hrank}); "
                                f"order is "
                                + " ≺ ".join(sorted(
                                    LOCK_ORDER, key=LOCK_ORDER.get))))
                            break
                    held.append((rname, rank, ce))
                    pushed += 1
                elif _is_lockish(ce) and held:
                    hname = held[-1][0]
                    findings.append((
                        "LOCK001", ce.lineno, ce.col_offset,
                        f"acquires unranked lock "
                        f"'{_lock_name(ce)}' while holding ranked "
                        f"{hname} lock — register it in LOCK_ATTRS or "
                        f"release first"))
            for child in node.body:
                walk(child, held)
            for _ in range(pushed):
                held.pop()
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    walk(tree, [])
    return findings


# ---------------------------------------------------------------- LOCK002

# calls that stall the calling thread on I/O or another thread
_BLOCKING_EXACT = {"fsync", "fdatasync", "sleep", "replace_durably",
                   "write_durably", "fsync_dir"}
_THREADISH = ("thread", "worker", "daemon", "proc", "pool")
# only these ranks guard latency-critical sections: a blocked servlet
# stalls its request queue; a blocked collector stalls every writer at
# the put barrier
_HOT_RANKS = ("servlet", "collector")


def _call_name(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _is_blocking_call(call: ast.Call) -> bool:
    name = _call_name(call)
    if name is None:
        return False
    if name in _BLOCKING_EXACT:
        return True
    if "flush" in name or "compact" in name:
        return True
    if name == "join" and isinstance(call.func, ast.Attribute):
        recv = ast.unparse(call.func.value).lower()
        return any(t in recv for t in _THREADISH)
    return False


def _self_callee(call: ast.Call) -> str | None:
    f = call.func
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "self"):
        return f.attr
    return None


def _blocking_methods(cls: ast.ClassDef) -> set[str]:
    """Fixpoint over ``self.m()`` edges: a method is blocking if it makes
    a blocking call directly or via another method of the same class."""
    methods = {m.name: m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    blocking: set[str] = set()
    for name, fn in methods.items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _is_blocking_call(node):
                blocking.add(name)
                break
    changed = True
    while changed:
        changed = False
        for name, fn in methods.items():
            if name in blocking:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _self_callee(node)
                    if callee in blocking:
                        blocking.add(name)
                        changed = True
                        break
    return blocking


def check_blocking_under_lock(path, tree, lines):
    findings = []

    def scan(node, hot_rank, blocking_methods):
        if isinstance(node, ast.ClassDef):
            bm = _blocking_methods(node)
            for child in ast.iter_child_nodes(node):
                scan(child, hot_rank, bm)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # lambdas/nested defs under a with-block run later, elsewhere
            for child in ast.iter_child_nodes(node):
                scan(child, None, blocking_methods)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = hot_rank
            for item in node.items:
                ranked = _rank_of(item.context_expr)
                if ranked is not None and ranked[0] in _HOT_RANKS:
                    inner = ranked[0]
            for child in node.body:
                scan(child, inner, blocking_methods)
            return
        if isinstance(node, ast.Call) and hot_rank is not None:
            name = _call_name(node)
            if _is_blocking_call(node):
                findings.append((
                    "LOCK002", node.lineno, node.col_offset,
                    f"blocking call {name}() inside a {hot_rank}-lock "
                    f"block"))
            else:
                callee = _self_callee(node)
                if callee in blocking_methods:
                    findings.append((
                        "LOCK002", node.lineno, node.col_offset,
                        f"self.{callee}() reaches a blocking call while "
                        f"the {hot_rank} lock is held"))
        for child in ast.iter_child_nodes(node):
            scan(child, hot_rank, blocking_methods)

    scan(tree, None, set())
    return findings
