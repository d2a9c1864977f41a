"""Whole-program import-graph layering checker.

The repo's dependency DAG is a contract, not a convention:

* ``repro_torch.core`` imports nothing internal except **lazy** ``interconnect``
  (inside a function body or a ``TYPE_CHECKING`` block) — the tuner must
  stay usable with no serving/telemetry stack on the path.
* ``repro_torch.interconnect`` imports nothing internal: the fabric is priced
  by core evaluators and serving alike, so it can depend on neither.
* ``repro_torch.telemetry`` imports nothing internal — every layer hands it a
  duck-typed handle precisely so the sink never pulls the stack in.
* ``repro_torch.analysis`` (this package) imports nothing internal *and* is
  stdlib-only, so the lint gate runs before any third-party install.

On top of the per-package contracts, the checker rejects any *eager*
import cycle among the scanned modules: cycles are where "it imported
fine on my machine" comes from, because resolution starts depending on
which module happened to be imported first.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
from typing import Iterator, Sequence

from .framework import FileContext, Finding, ProgramRule, register


@dataclasses.dataclass(frozen=True)
class ImportEdge:
    src_module: str
    src_display: str
    target: str  # dotted absolute target ("repro_torch.serve.simulator", "numpy")
    line: int
    col: int
    lazy: bool  # inside a function body or TYPE_CHECKING block


@dataclasses.dataclass(frozen=True)
class LayerContract:
    eager: frozenset[str]  # internal top packages importable at module scope
    lazy: frozenset[str]  # additionally importable lazily


CONTRACTS: dict[str, LayerContract] = {
    "core": LayerContract(
        eager=frozenset(), lazy=frozenset({"interconnect", "power", "faults"})
    ),
    "interconnect": LayerContract(eager=frozenset(), lazy=frozenset()),
    "power": LayerContract(eager=frozenset(), lazy=frozenset()),
    "telemetry": LayerContract(eager=frozenset(), lazy=frozenset()),
    "analysis": LayerContract(eager=frozenset(), lazy=frozenset()),
    "faults": LayerContract(eager=frozenset(), lazy=frozenset()),
}

#: packages that must import nothing outside the standard library
STDLIB_ONLY = frozenset({"analysis", "power", "faults"})


def _is_type_checking_test(test: ast.expr) -> bool:
    if isinstance(test, ast.Name):
        return test.id == "TYPE_CHECKING"
    if isinstance(test, ast.Attribute):
        return test.attr == "TYPE_CHECKING"
    return False


def collect_edges(ctx: FileContext) -> list[ImportEdge]:
    """Every import in the file, resolved to absolute dotted targets."""
    edges: list[ImportEdge] = []

    def resolve_relative(node: ast.ImportFrom) -> str:
        parts = ctx.module.split(".")
        if not ctx.is_package:
            parts = parts[:-1]
        up = node.level - 1
        base = parts[: len(parts) - up] if up else parts
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    def visit(node: ast.AST, lazy: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_lazy = lazy
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                child_lazy = True
            elif isinstance(child, ast.If) and _is_type_checking_test(child.test):
                child_lazy = True
            if isinstance(child, ast.Import):
                for a in child.names:
                    edges.append(
                        ImportEdge(
                            ctx.module, ctx.display, a.name,
                            child.lineno, child.col_offset, lazy,
                        )
                    )
            elif isinstance(child, ast.ImportFrom):
                base = (
                    resolve_relative(child) if child.level else (child.module or "")
                )
                if base:
                    edges.append(
                        ImportEdge(
                            ctx.module, ctx.display, base,
                            child.lineno, child.col_offset, lazy,
                        )
                    )
                for a in child.names:
                    if base and a.name != "*":
                        edges.append(
                            ImportEdge(
                                ctx.module, ctx.display, f"{base}.{a.name}",
                                child.lineno, child.col_offset, lazy,
                            )
                        )
            else:
                visit(child, child_lazy)

    visit(ctx.tree, lazy=False)
    return edges


def _top_package(module: str) -> str:
    """"core" for "repro_torch.core.seed"; "" for non-internal modules."""
    parts = module.split(".")
    if parts[0] == "repro_torch" and len(parts) > 1:
        return parts[1]
    return ""


def _is_internal(target: str) -> bool:
    return target == "repro_torch" or target.startswith("repro_torch.")


@register
class ImportLayeringRule(ProgramRule):
    """Enforce the dependency DAG and reject eager import cycles."""

    name = "import-layering"
    description = "layering-contract violation or eager import cycle"

    def check_program(self, ctxs: Sequence[FileContext]) -> Iterator[Finding]:
        modules = {c.module for c in ctxs}
        all_edges: list[ImportEdge] = []
        for ctx in ctxs:
            all_edges.extend(collect_edges(ctx))
        yield from self._contract_findings(all_edges)
        yield from self._cycle_findings(all_edges, modules)

    # -- per-package contracts ----------------------------------------------

    def _contract_findings(self, edges: list[ImportEdge]) -> Iterator[Finding]:
        seen: set[tuple] = set()
        for e in edges:
            src_top = _top_package(e.src_module)
            contract = CONTRACTS.get(src_top)
            if contract is not None and _is_internal(e.target):
                tgt_top = _top_package(e.target)
                if tgt_top and tgt_top != src_top:
                    allowed = contract.eager | (contract.lazy if e.lazy else frozenset())
                    if tgt_top not in allowed:
                        key = (e.src_display, e.line, tgt_top)
                        if key not in seen:
                            seen.add(key)
                            lazily = (
                                " (allowed lazily: move it inside the function "
                                "or a TYPE_CHECKING block)"
                                if tgt_top in contract.lazy
                                else ""
                            )
                            yield Finding(
                                e.src_display, e.line, e.col, self.name,
                                self.severity,
                                f"repro_torch.{src_top} may not import "
                                f"repro_torch.{tgt_top}{lazily}",
                            )
            if src_top in STDLIB_ONLY and not _is_internal(e.target):
                top = e.target.split(".")[0]
                if top not in sys.stdlib_module_names:
                    key = (e.src_display, e.line, "stdlib", top)
                    if key not in seen:
                        seen.add(key)
                        yield Finding(
                            e.src_display, e.line, e.col, self.name,
                            self.severity,
                            f"repro_torch.{src_top} is stdlib-only but imports "
                            f"{top!r}",
                        )

    # -- eager cycle detection ----------------------------------------------

    def _cycle_findings(
        self, edges: list[ImportEdge], modules: set[str]
    ) -> Iterator[Finding]:
        graph: dict[str, set[str]] = {m: set() for m in modules}
        edge_at: dict[tuple[str, str], ImportEdge] = {}
        for e in edges:
            if e.lazy:
                continue
            tgt = self._resolve_scanned(e.target, modules)
            if tgt is None or tgt == e.src_module:
                continue
            graph[e.src_module].add(tgt)
            edge_at.setdefault((e.src_module, tgt), e)
        for comp in self._sccs(graph):
            if len(comp) < 2:
                continue
            cyc = sorted(comp)
            head = cyc[0]
            nxt = next(t for t in sorted(graph[head]) if t in comp)
            e = edge_at[(head, nxt)]
            yield Finding(
                e.src_display, e.line, e.col, self.name, self.severity,
                "eager import cycle: " + " -> ".join(cyc + [cyc[0]]),
            )

    @staticmethod
    def _resolve_scanned(target: str, modules: set[str]) -> str | None:
        """Deepest scanned module matching the dotted target, if any."""
        parts = target.split(".")
        for i in range(len(parts), 0, -1):
            cand = ".".join(parts[:i])
            if cand in modules:
                return cand
        return None

    @staticmethod
    def _sccs(graph: dict[str, set[str]]) -> list[set[str]]:
        """Tarjan strongly-connected components (iterative)."""
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        out: list[set[str]] = []
        counter = [0]

        for root in sorted(graph):
            if root in index:
                continue
            work: list[tuple[str, Iterator[str]]] = [(root, iter(sorted(graph[root])))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
                if low[v] == index[v]:
                    comp = set()
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.add(w)
                        if w == v:
                            break
                    out.append(comp)
        return out
