"""Rule framework for shisha-lint.

The linter is deliberately zero-dependency (stdlib ``ast`` only) so it can
run as a CI gate before any third-party package is importable.  Two rule
shapes exist:

* :class:`Rule` — per-file AST rules.  ``check(ctx)`` yields findings for
  one parsed file; rules never see the filesystem.
* :class:`ProgramRule` — whole-program rules (the import-graph layering
  checker).  ``check_program(ctxs)`` sees every scanned file at once.

Findings carry a rule name, severity, and location; suppression is via
``# shisha: allow(<rule>[, <rule>...])`` pragmas, either trailing on the
offending line or on a comment line directly above it.  Two framework
checks keep the pragma set honest: an unknown rule name in a pragma is a
``bad-pragma`` error, and a pragma that suppresses nothing is a
``useless-suppression`` error — so every pragma in a clean tree is
load-bearing by construction (deleting one re-surfaces a real finding).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator, Sequence

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

#: framework-level pseudo-rules (not in the registry, never suppressible)
BAD_PRAGMA = "bad-pragma"
USELESS_SUPPRESSION = "useless-suppression"
PARSE_ERROR = "parse-error"

_PRAGMA_RE = re.compile(r"#\s*shisha:\s*allow\(\s*([^)]*?)\s*\)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint finding, ordered by location for stable reports."""

    path: str
    line: int
    col: int
    rule: str
    severity: str
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity}: [{self.rule}] {self.message}"
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One ``# shisha: allow(...)`` comment."""

    line: int  # line the pragma comment sits on
    applies_to: tuple[int, ...]  # finding lines it suppresses
    rules: tuple[str, ...]


@dataclasses.dataclass
class FileContext:
    """One parsed source file, as seen by per-file rules."""

    path: Path  # real filesystem path
    display: str  # path as reported in findings
    module: str  # dotted module name ("repro_torch.core.seed", "fixture_mod")
    is_package: bool  # True for __init__.py
    source: str
    tree: ast.Module
    pragmas: tuple[Pragma, ...]

    @property
    def top_package(self) -> str:
        """Top sub-package under ``repro_torch`` ("core", "serve", ...) or ""."""
        parts = self.module.split(".")
        if parts[0] == "repro_torch" and len(parts) > 1:
            return parts[1]
        return ""


class Rule:
    """Per-file AST rule.  Subclasses set ``name``/``severity`` and yield
    findings from :meth:`check`."""

    name: str = ""
    severity: str = SEVERITY_ERROR
    description: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST | int, message: str) -> Finding:
        if isinstance(node, int):
            line, col = node, 0
        else:
            line, col = node.lineno, node.col_offset
        return Finding(ctx.display, line, col, self.name, self.severity, message)


class ProgramRule(Rule):
    """Whole-program rule: sees every scanned file at once."""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        return iter(())

    def check_program(self, ctxs: Sequence[FileContext]) -> Iterator[Finding]:
        raise NotImplementedError


#: rule-name -> rule instance; populated by :func:`register`
RULES: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule (by its ``name``) to the registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if rule.name in RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return cls


def parse_pragmas(source: str) -> tuple[Pragma, ...]:
    """Extract ``# shisha: allow(...)`` pragmas from *comment tokens*.

    Tokenizing (rather than regexing raw lines) keeps pragma **mentions**
    inside docstrings — like the ones in this package — from counting as
    live pragmas.  A pragma trailing code applies to its own line; a
    pragma on a comment-only line applies to the next line (and its own,
    so a finding reported *at* the comment is also covered).
    """
    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return ()
    code_lines = {
        t.start[0]
        for t in tokens
        if t.type
        not in (tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                tokenize.DEDENT, tokenize.ENDMARKER)
    }
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        i = tok.start[0]
        applies = (i,) if i in code_lines else (i, i + 1)
        out.append(Pragma(line=i, applies_to=applies, rules=rules))
    return tuple(out)


def _module_name(file: Path, root: Path) -> tuple[str, bool]:
    """Dotted module name for ``file`` relative to scan root.

    If a ``repro_torch`` path component exists, the name is rooted there, so
    a fixture tree like ``layering_bad/repro_torch/telemetry/x.py`` lints as
    module ``repro_torch.telemetry.x`` and the layering contracts apply.
    """
    try:
        rel = file.resolve().relative_to(root.resolve())
    except ValueError:
        rel = Path(file.name)
    parts = list(rel.with_suffix("").parts)
    # a scan root that is itself a package keeps its name in the module
    # path ("benchmarks/run.py" lints as benchmarks.run, not run), so
    # package-scoped allowlists and layering contracts still apply
    anchor = root
    while (anchor / "__init__.py").exists():
        parts.insert(0, anchor.name)
        anchor = anchor.parent
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch") :]
    is_pkg = parts[-1] == "__init__"
    if is_pkg:
        parts = parts[:-1] or [root.name]
    return ".".join(parts), is_pkg


def collect_files(paths: Sequence[str | Path]) -> tuple[list[FileContext], list[Finding]]:
    """Parse every ``.py`` under the given files/directories.

    Returns (contexts, parse_errors); unparseable files become
    ``parse-error`` findings rather than crashing the run.
    """
    ctxs: list[FileContext] = []
    errors: list[Finding] = []
    seen: set[Path] = set()
    for raw in paths:
        p = Path(raw)
        root = p.parent if p.is_file() else p
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            rp = f.resolve()
            if rp in seen or "__pycache__" in f.parts:
                continue
            seen.add(rp)
            display = str(f)
            source = f.read_text(encoding="utf-8")
            module, is_pkg = _module_name(f, root)
            try:
                tree = ast.parse(source, filename=display)
            except SyntaxError as e:
                errors.append(
                    Finding(
                        display, e.lineno or 1, (e.offset or 1) - 1,
                        PARSE_ERROR, SEVERITY_ERROR, f"syntax error: {e.msg}",
                    )
                )
                continue
            ctxs.append(
                FileContext(
                    path=f,
                    display=display,
                    module=module,
                    is_package=is_pkg,
                    source=source,
                    tree=tree,
                    pragmas=parse_pragmas(source),
                )
            )
    return ctxs, errors


def source_context(
    source: str, display: str = "<memory>", module: str = "_memory_"
) -> FileContext:
    """A FileContext for an in-memory snippet (tests, pragma-strip checks)."""
    return FileContext(
        path=Path(display),
        display=display,
        module=module,
        is_package=False,
        source=source,
        tree=ast.parse(source, filename=display),
        pragmas=parse_pragmas(source),
    )


@dataclasses.dataclass
class Report:
    """Outcome of one lint run."""

    findings: list[Finding]  # unsuppressed, sorted by location
    suppressed: list[Finding]
    n_files: int
    roots: tuple[str, ...] = ()

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_WARNING]

    def exit_code(self, *, report_only: bool = False, strict: bool = False) -> int:
        if report_only:
            return 0
        if self.errors or (strict and self.warnings):
            return 1
        return 0


def _apply_suppressions(
    ctx: FileContext, findings: Iterable[Finding], known_rules: set[str]
) -> tuple[list[Finding], list[Finding], list[Finding]]:
    """Split ``findings`` into (kept, suppressed) and emit pragma hygiene
    findings (bad-pragma / useless-suppression) for this file."""
    allow: dict[int, set[str]] = {}
    for pr in ctx.pragmas:
        for line in pr.applies_to:
            allow.setdefault(line, set()).update(pr.rules)
    kept, suppressed = [], []
    used_lines: set[int] = set()
    for f in findings:
        if f.rule in allow.get(f.line, ()):
            suppressed.append(f)
            used_lines.add(f.line)
        else:
            kept.append(f)
    hygiene: list[Finding] = []
    for pr in ctx.pragmas:
        unknown = [r for r in pr.rules if r not in known_rules]
        if unknown:
            hygiene.append(
                Finding(
                    ctx.display, pr.line, 0, BAD_PRAGMA, SEVERITY_ERROR,
                    f"unknown rule name(s) in pragma: {', '.join(unknown)}",
                )
            )
        elif not any(line in used_lines for line in pr.applies_to):
            hygiene.append(
                Finding(
                    ctx.display, pr.line, 0, USELESS_SUPPRESSION, SEVERITY_ERROR,
                    f"pragma suppresses nothing (rules: {', '.join(pr.rules)}); "
                    "delete it or move it to the offending line",
                )
            )
    return kept, suppressed, hygiene


def run(
    paths: Sequence[str | Path], rules: Sequence[Rule] | None = None
) -> Report:
    """Lint files/directories with the given rules (default: full registry)."""
    ctxs, parse_errors = collect_files(paths)
    return _run_contexts(ctxs, rules, parse_errors, roots=tuple(str(p) for p in paths))


def lint_source(
    source: str,
    display: str = "<memory>",
    module: str = "_memory_",
    rules: Sequence[Rule] | None = None,
) -> Report:
    """Lint one in-memory snippet (per-file rules plus pragma hygiene).

    Program rules see the snippet as a one-file program, so layering
    contracts still apply when ``module`` names a ``repro_torch.*`` module.
    """
    ctx = source_context(source, display, module)
    return _run_contexts([ctx], rules, [], roots=(display,))


def _run_contexts(
    ctxs: Sequence[FileContext],
    rules: Sequence[Rule] | None,
    parse_errors: list[Finding],
    roots: tuple[str, ...],
) -> Report:
    active = list(rules) if rules is not None else list(RULES.values())
    known = {r.name for r in active} | {r.name for r in RULES.values()}
    per_file: dict[str, list[Finding]] = {c.display: [] for c in ctxs}
    file_rules = [r for r in active if not isinstance(r, ProgramRule)]
    program_rules = [r for r in active if isinstance(r, ProgramRule)]
    for ctx in ctxs:
        for rule in file_rules:
            per_file[ctx.display].extend(rule.check(ctx))
    for rule in program_rules:
        for f in rule.check_program(ctxs):
            per_file.setdefault(f.path, []).append(f)
    kept_all: list[Finding] = list(parse_errors)
    suppressed_all: list[Finding] = []
    by_display = {c.display: c for c in ctxs}
    for display, found in per_file.items():
        ctx = by_display.get(display)
        if ctx is None:
            kept_all.extend(found)
            continue
        kept, suppressed, hygiene = _apply_suppressions(ctx, found, known)
        kept_all.extend(kept)
        kept_all.extend(hygiene)
        suppressed_all.extend(suppressed)
    return Report(
        findings=sorted(kept_all),
        suppressed=sorted(suppressed_all),
        n_files=len(ctxs),
        roots=roots,
    )
