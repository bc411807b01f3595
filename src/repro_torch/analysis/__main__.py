"""``python -m repro_torch.analysis [paths] [--select RL00x,..] [--json-out f]``

The port's repro-lint CLI. Exit 0 when the tree is clean (suppressions
with reasons included), 1 when any diagnostic survives, 2 on a bad
``--select`` or a missing path. Runs on a bare interpreter — no torch,
no jax, no third-party imports.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.diagnostics import RULES
from repro_torch.analysis.engine import lint_paths, parse_select

_DEFAULT_PATHS = ["src/repro_torch"]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint for the port: AST-enforced invariants "
                    "(RL001 batch-stability, RL002 host-sync safety, RL003 "
                    "lock-discipline, RL004 key-completeness, RL005 kernel "
                    "purity, RL006 obs-boundary)")
    parser.add_argument("paths", nargs="*", default=None,
                        help=f"files/dirs to lint (default: "
                             f"{' '.join(_DEFAULT_PATHS)})")
    parser.add_argument("--select", default=None, metavar="CODES",
                        help="comma-separated rule codes to run "
                             "(default: all; disables stale-suppression "
                             "checking)")
    parser.add_argument("--json-out", default=None, metavar="FILE",
                        help="write a BENCH-schema JSON artifact "
                             "(files/diagnostics/suppressions/rules)")
    parser.add_argument("--explain", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    if args.explain:
        for code in sorted(RULES):
            print(f"{code}  {RULES[code]}")
        return 0

    try:
        select = parse_select(args.select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        result = lint_paths(args.paths or _DEFAULT_PATHS, select=select)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    for diag in result.diagnostics:
        print(diag.render())

    if args.json_out:
        payload = {
            "files": len(result.files),
            "diagnostics": [
                {"path": d.path, "line": d.line, "code": d.code,
                 "message": d.message}
                for d in result.diagnostics],
            "suppressions": result.suppressions,
            "rules": {code: RULES[code] for code in sorted(RULES)},
        }
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")

    n = len(result.diagnostics)
    scanned = len(result.files)
    if n:
        counts = ", ".join(f"{c}×{k}" for c, k in
                           sorted(result.rule_counts.items()))
        print(f"\n{n} finding(s) in {scanned} file(s) [{counts}]; "
              f"{result.suppressions} suppression(s) honored",
              file=sys.stderr)
        return 1
    print(f"clean: {scanned} file(s), {result.suppressions} explained "
          f"suppression(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
