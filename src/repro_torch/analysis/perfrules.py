"""PERF001 / OBS001 — batched-store-access and guarded-observability rules.

PERF001: the storage API is batch-first (paper §4.4 — one round trip,
one barrier, one index probe per *batch*); per-cid ``get``/``put`` in a
loop silently multiplies every fixed cost by the batch size.  OBS001:
registry calls on hot paths must sit behind ``REGISTRY.enabled`` so the
disabled-obs configuration stays zero-cost (the PR-8 overhead gate
enforces the budget; this rule points at the offending line).
"""
from __future__ import annotations

import ast

__all__ = ["check_n_plus_one", "check_obs_guard"]

_VERBS = {"get", "put", "has", "delete"}
_BATCH_VERBS = {"get_many", "put_many", "has_many", "delete_many"}
_STOREISH = ("store", "backend")


def _receiver_text(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return ast.unparse(call.func.value).lower()
    return ""


def check_n_plus_one(path, tree, lines):
    findings = []

    def scan(node, in_loop):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for child in ast.iter_child_nodes(node):
                scan(child, False)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            for child in node.body:
                scan(child, True)
            for child in node.orelse:
                scan(child, in_loop)
            return
        if isinstance(node, ast.Call) and in_loop:
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            recv = _receiver_text(node)
            storeish = any(s in recv for s in _STOREISH)
            if (name in _VERBS and storeish
                    # two-positional-arg .get(k, default) is dict-style
                    and not (name == "get" and len(node.args) > 1)):
                findings.append((
                    "PERF001", node.lineno, node.col_offset,
                    f"per-item {recv}.{name}() inside a loop — batch the "
                    f"cids and make one {name}_many() call"))
            elif (name in _BATCH_VERBS and node.args
                    and isinstance(node.args[0], ast.List)
                    and len(node.args[0].elts) == 1):
                findings.append((
                    "PERF001", node.lineno, node.col_offset,
                    f"{name}() with a single-element list inside a loop "
                    f"— hoist the batch out of the loop"))
        for child in ast.iter_child_nodes(node):
            scan(child, in_loop)

    scan(tree, False)
    return findings


# ---------------------------------------------------------------- OBS001

_REG_METHODS = {"histogram", "counter", "gauge"}


def _is_registry_recv(expr: ast.expr) -> bool:
    text = ast.unparse(expr)
    return text in ("_OBS", "REGISTRY") or text.endswith(".REGISTRY")


def _test_mentions_enabled(test: ast.expr) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "enabled"
               for n in ast.walk(test))


def _guarded_by_early_return(fn, lineno: int) -> bool:
    """``if not X.enabled: return`` (or raise) above the call, at the top
    level of the enclosing function body."""
    for stmt in fn.body:
        if stmt.lineno >= lineno:
            break
        if (isinstance(stmt, ast.If) and _test_mentions_enabled(stmt.test)
                and stmt.body
                and isinstance(stmt.body[-1], (ast.Return, ast.Raise))):
            return True
    return False


def check_obs_guard(path, tree, lines):
    findings = []
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REG_METHODS
                and _is_registry_recv(node.func.value)):
            continue
        guarded = False
        fn = None
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, ast.If) and _test_mentions_enabled(cur.test):
                guarded = True
                break
            if (fn is None and isinstance(cur, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))):
                fn = cur
        if not guarded and fn is not None:
            guarded = _guarded_by_early_return(fn, node.lineno)
        if not guarded:
            findings.append((
                "OBS001", node.lineno, node.col_offset,
                f"REGISTRY.{node.func.attr}() not behind an "
                f"`.enabled` guard — hot paths must be free when obs "
                f"is off"))
    return findings
