"""CONTRACT001 / CONTRACT002 — typed-errors-only and monotonic-time rules.

CONTRACT001: runtime invariants in the engine must surface as classes
from ``repro.errors`` (callers catch ``ReproError`` subtrees; asserts
vanish under ``python -O`` and generic ``Exception`` is uncatchable
precisely).  CONTRACT002: wall-clock ``time.time()`` steps under NTP and
breaks duration math — only exporters that serialize timestamps for
humans may use it.
"""
from __future__ import annotations

import ast

__all__ = ["check_monotonic_time", "check_typed_errors"]

_GENERIC = {"Exception", "BaseException", "AssertionError"}


def check_typed_errors(path, tree, lines):
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            findings.append((
                "CONTRACT001", node.lineno, node.col_offset,
                "assert used for a runtime invariant — it disappears "
                "under -O; raise InvariantViolation (or a more specific "
                "repro.errors class)"))
        elif isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in _GENERIC:
                findings.append((
                    "CONTRACT001", node.lineno, node.col_offset,
                    f"raise {name} is untyped — raise a repro.errors "
                    f"class so callers can catch precisely"))
    return findings


def check_monotonic_time(path, tree, lines):
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "time"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "time"):
                findings.append((
                    "CONTRACT002", node.lineno, node.col_offset,
                    "time.time() is wall clock — use time.monotonic() / "
                    "perf_counter() for durations and ordering"))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time" and any(a.name == "time"
                                             for a in node.names):
                findings.append((
                    "CONTRACT002", node.lineno, node.col_offset,
                    "`from time import time` imports the wall clock — "
                    "import monotonic/perf_counter instead"))
    return findings
