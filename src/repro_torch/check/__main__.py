"""CLI: ``python -m repro_torch.check <paths...>``.

Exit code is the finding count (capped at 255 so it survives the shell),
so a gate is a bare invocation.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .runner import run_check
from .registry import all_rules
from .report import render_json, render_text


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static contract linter for the PyTorch port and its "
                    "CUDA sources (determinism, launch, collective and "
                    "page-protocol rules).")
    p.add_argument("paths", nargs="*", default=["src/repro_torch"],
                   help="files or directories to check "
                        "(default: src/repro_torch)")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--output", default=None,
                   help="also write the report to this file")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    args = p.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rid, rule in rules.items():
            print(f"{rid}  {rule.title}")
        return 0

    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    try:
        findings = run_check(args.paths, rule_ids=rule_ids)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        report = render_json(
            findings, {rid: r.title for rid, r in rules.items()})
    else:
        report = render_text(findings)
    print(report)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(report + "\n")
    return min(len(findings), 255)


if __name__ == "__main__":
    sys.exit(main())
