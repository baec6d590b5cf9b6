"""CLI: ``python -m repro_torch.analysis [paths...] [--list-rules] [--json]``.

Exit 0 when every finding is suppressed (with justification), 1 otherwise
— wired into CI as its own gate next to ruff and the test tiers.
"""
from __future__ import annotations

import argparse
import json
import sys

from .engine import RULES, run_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based concurrency & contract rules for this repo")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to scan (default: src)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, rule in sorted(RULES.items()):
            print(f"{code:12} {rule.summary}\n{'':12} fix: {rule.fixit}")
        return 0

    findings = run_paths(args.paths or ["src"])
    if args.as_json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"{n} finding{'s' if n != 1 else ''} "
              f"in {', '.join(args.paths or ['src'])}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
