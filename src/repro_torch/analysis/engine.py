"""Rule engine core: file walking, suppression parsing, finding filtering.

Checkers (lockrules / contracts / perfrules) are pure functions
``(path, tree, lines) -> [(code, line, col, message), ...]`` — they know
nothing about suppression or scoping, which live here:

* **scope** — each rule declares a path predicate (e.g. CONTRACT001 is
  src-only and skips the ML scaffolding dirs).  Findings outside a rule's
  scope are dropped before suppression matching.
* **suppression** — ``# repro: allow(RULE[, RULE]): justification`` on the
  flagged line, or anywhere in the contiguous comment block immediately
  above it.  A used allow with no justification raises META001; an allow
  that matched nothing raises META002.  META findings are never
  suppressible, so every ``allow`` in the tree stays documented and
  load-bearing.

The rules, their messages, the scoping strings (``_ML_DIRS``, ``_ML_FILES``
and the ``repro/obs/`` exemptions match only the JAX package's paths) and
the allow syntax are the JAX package's, unchanged: both engines give the
same findings on the same tree, and the port's files stay under every rule.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

__all__ = ["Allow", "Finding", "Rule", "RULES", "iter_py_files",
           "run_paths", "scan_file"]


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        fixit = RULES[self.rule].fixit if self.rule in RULES else ""
        hint = f"  [{fixit}]" if fixit else ""
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} {self.message}{hint}")


@dataclass
class Allow:
    line: int                 # line the comment sits on
    target: int | None        # code line the allow applies to (None: dangling)
    rules: tuple[str, ...]
    justification: str
    used: bool = field(default=False)


@dataclass(frozen=True)
class Rule:
    code: str
    summary: str
    fixit: str


RULES: dict[str, Rule] = {}


def _rule(code: str, summary: str, fixit: str) -> None:
    RULES[code] = Rule(code, summary, fixit)


_rule("LOCK001", "lock acquired out of rank order",
      "acquire locks in LOCK_ORDER rank order (see repro/core/locking.py)")
_rule("LOCK002", "blocking call while holding a servlet/collector lock",
      "move fsync/sleep/join/compaction outside the lock block")
_rule("CONTRACT001", "bare assert/Exception for a runtime invariant",
      "raise a typed error from repro/errors.py")
_rule("CONTRACT002", "wall-clock time.time() outside exporters",
      "use time.monotonic()/perf_counter(); wall clock drifts and steps")
_rule("PERF001", "per-item store access inside a loop over cids",
      "batch with get_many/put_many or a WriteBuffer")
_rule("OBS001", "unguarded obs registry call on a hot path",
      "guard with `if REGISTRY.enabled:` or use the obs.* wrappers")
_rule("META001", "suppression without a justification",
      "append `: why` to the allow comment")
_rule("META002", "suppression that matches no finding",
      "delete the stale allow comment")


# --------------------------------------------------------------- scoping

# ML scaffolding kept out of the storage-engine contract rules: these
# trees follow JAX idiom (asserts on shapes, wall-clock step timers) and
# are exercised by their own test tiers.
_ML_DIRS = ("repro/models/", "repro/kernels/", "repro/train/",
            "repro/configs/", "repro/launch/", "repro/runtime/")
_ML_FILES = ("repro/roofline.py", "repro/shardings.py")


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _is_src(p: str) -> bool:
    return p.startswith("src/") or "/src/" in p


def _is_ml(p: str) -> bool:
    return any(d in p for d in _ML_DIRS) or p.endswith(_ML_FILES)


def rule_in_scope(code: str, path: str) -> bool:
    p = _norm(path)
    if code.startswith("LOCK") or code == "PERF001":
        return True
    if code == "CONTRACT001":
        return _is_src(p) and not _is_ml(p)
    if code == "CONTRACT002":
        # exporters serialize for humans/external systems: wall clock is
        # the point there
        return (_is_src(p) and not _is_ml(p)
                and not p.endswith("repro/obs/export.py"))
    if code == "OBS001":
        # the obs package itself is the guard's implementation
        return _is_src(p) and not _is_ml(p) and "repro/obs/" not in p
    return True


# ----------------------------------------------------------- suppression

_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\(\s*([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)\s*\)"
    r"\s*(?::\s*(\S.*))?$")


def _comment_only(line: str) -> bool:
    s = line.strip()
    return s.startswith("#")


def parse_allows(lines: list[str]) -> list[Allow]:
    allows: list[Allow] = []
    n = len(lines)
    for i, raw in enumerate(lines, 1):
        m = _ALLOW_RE.search(raw)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(","))
        just = (m.group(2) or "").strip()
        if _comment_only(raw):
            # the allow governs the first code line below its contiguous
            # comment block (so multi-line justifications read naturally)
            j = i
            while j <= n and _comment_only(lines[j - 1]):
                j += 1
            target = j if j <= n and lines[j - 1].strip() else None
        else:
            target = i          # trailing comment: governs its own line
        allows.append(Allow(line=i, target=target, rules=rules,
                            justification=just))
    return allows


# ------------------------------------------------------------ file scan

def _checkers():
    from . import contracts, lockrules, perfrules
    return (lockrules.check_lock_order, lockrules.check_blocking_under_lock,
            contracts.check_typed_errors, contracts.check_monotonic_time,
            perfrules.check_n_plus_one, perfrules.check_obs_guard)


def scan_file(path: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("SYNTAX", path, e.lineno or 1, 0, str(e.msg))]
    lines = src.splitlines()
    raw: list[tuple[str, int, int, str]] = []
    for checker in _checkers():
        raw.extend(checker(path, tree, lines))

    allows = parse_allows(lines)
    by_target: dict[int, list[Allow]] = {}
    for a in allows:
        if a.target is not None:
            by_target.setdefault(a.target, []).append(a)

    out: list[Finding] = []
    for code, line, col, msg in raw:
        if not rule_in_scope(code, path):
            continue
        hit = None
        for a in by_target.get(line, ()):
            if code in a.rules and not code.startswith("META"):
                hit = a
                break
        if hit is None:
            out.append(Finding(code, path, line, col, msg))
        else:
            hit.used = True
    for a in allows:
        if a.used and not a.justification:
            out.append(Finding("META001", path, a.line, 0,
                               f"allow({', '.join(a.rules)}) has no "
                               f"justification"))
        if not a.used:
            out.append(Finding("META002", path, a.line, 0,
                               f"allow({', '.join(a.rules)}) matched no "
                               f"finding — stale?"))
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def iter_py_files(paths: list[str]):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def run_paths(paths: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(scan_file(f))
    return findings
