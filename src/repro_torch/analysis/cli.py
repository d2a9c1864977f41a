"""Command-line entry point: ``python -m repro_torch.analysis [paths...]``."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Sequence

from .framework import run
from .report import render_json, render_rules, render_text


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "shisha-lint: AST-based determinism, layering, and "
            "simulation-contract checker"
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["src"],
        help="files or directories to lint (default: src)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format (default: text)",
    )
    parser.add_argument(
        "--report-only", action="store_true",
        help="always exit 0: report findings without gating",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="warnings also fail the gate",
    )
    parser.add_argument(
        "--output", metavar="FILE",
        help="also write the report to FILE",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule registry and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        print(render_rules())
        return 0

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"error: no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2

    report = run(args.paths)
    text = render_json(report) if args.format == "json" else render_text(report)
    print(text)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n", encoding="utf-8")
    return report.exit_code(report_only=args.report_only, strict=args.strict)
