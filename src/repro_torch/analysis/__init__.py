"""Repo-rule engine: AST-based concurrency & contract analysis.

Static companion to the runtime lock witness (repro_torch.core.locking).
Rules encode invariants the test suite cannot cheaply cover — lock-acquisition
order, blocking I/O under hot locks, typed-error discipline, monotonic-time
discipline, batched store access, guarded observability — and run in CI as
their own gate (``python -m repro_torch.analysis src tests benchmarks``).

Suppression: ``# repro: allow(RULE[, RULE]): justification`` on the flagged
line or in the contiguous comment block immediately above it.  A bare allow
without a justification still suppresses the finding but raises META001;
an allow that never matches a finding raises META002 — so every suppression
stays load-bearing and documented.
"""
from .engine import (Allow, Finding, Rule, RULES, iter_py_files, run_paths,
                     scan_file)

__all__ = ["Allow", "Finding", "Rule", "RULES", "iter_py_files",
           "run_paths", "scan_file"]
