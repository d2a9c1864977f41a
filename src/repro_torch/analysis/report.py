"""Text and JSON rendering for shisha-lint reports."""

from __future__ import annotations

import json

from .framework import RULES, Report

TOOL = "shisha-lint"
VERSION = "1.0"


def render_text(report: Report) -> str:
    lines = [f.format() for f in report.findings]
    n_err, n_warn = len(report.errors), len(report.warnings)
    summary = (
        f"{TOOL}: {report.n_files} files, {n_err} error(s), "
        f"{n_warn} warning(s), {len(report.suppressed)} suppressed"
    )
    return "\n".join(lines + [summary])


def render_json(report: Report) -> str:
    payload = {
        "tool": TOOL,
        "version": VERSION,
        "roots": list(report.roots),
        "files": report.n_files,
        "summary": {
            "errors": len(report.errors),
            "warnings": len(report.warnings),
            "suppressed": len(report.suppressed),
        },
        "findings": [f.to_json() for f in report.findings],
        "suppressed": [f.to_json() for f in report.suppressed],
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def render_rules() -> str:
    """The registry as a table (``--list-rules``)."""
    rows = [
        (name, rule.severity, rule.description)
        for name, rule in sorted(RULES.items())
    ]
    width = max(len(r[0]) for r in rows)
    return "\n".join(
        f"{name:<{width}}  {sev:<7}  {desc}" for name, sev, desc in rows
    )
