"""shisha-lint, the port's copy: AST-based determinism, layering, and
simulation-contract checker for this repository.

Usage: ``python -m repro_torch.analysis src/repro_torch`` lints every
``.py`` file under the given roots and exits non-zero on any error-severity
finding (``--report-only`` downgrades the gate, ``--strict`` upgrades
warnings, ``--format=json`` emits a machine-readable report for CI
artifacts, ``--list-rules`` prints the registry).  The suite is pure
stdlib — no third-party imports, enforced on itself by the
``import-layering`` rule — so the CI lint gate runs before any dependency
install.  Rules guard the contracts the simulation stack's bit-for-bit
reproducibility rests on: no wall-clock reads or unseeded RNGs on
simulated paths, no iteration-order tie-breaks (sets, unkeyed dict-view
ordering, ``id()`` keys, float accumulation over unordered iterables), no
unguarded duck-typed telemetry handles, no events scheduled behind the
loop clock, and the core/interconnect/telemetry layering DAG.  Intentional
exceptions are annotated in place with ``# shisha: allow(<rule>)``; a
pragma that stops suppressing anything becomes a ``useless-suppression``
error, so the pragma inventory can never go stale.  The copy roots module
names at ``repro_torch`` where the JAX package's roots them at ``repro``, so
the layering contracts hold the port's own packages.
"""

from .framework import (
    RULES,
    Finding,
    FileContext,
    ProgramRule,
    Report,
    Rule,
    lint_source,
    register,
    run,
)
from . import layering as _layering  # noqa: F401  (registers import-layering)
from . import rules as _rules  # noqa: F401  (registers the AST rules)
from .report import render_json, render_rules, render_text

__all__ = [
    "RULES",
    "FileContext",
    "Finding",
    "ProgramRule",
    "Report",
    "Rule",
    "lint_source",
    "register",
    "render_json",
    "render_rules",
    "render_text",
    "run",
]
