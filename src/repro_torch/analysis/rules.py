"""Per-file AST rules for shisha-lint.

Each rule guards one repo contract (see the rule ↔ contract table in
ROADMAP.md ``## Static analysis``).  Rules are pattern checkers, not type
inference: they flag the shapes that have actually bitten simulated-path
code (wall-clock reads, unseeded RNGs, iteration-order tie-breaks), and
intentional exceptions carry a ``# shisha: allow(<rule>)`` pragma so the
exception is visible at the call site.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .framework import (
    SEVERITY_WARNING,
    FileContext,
    Finding,
    Rule,
    register,
)


class ImportMap:
    """Local alias -> dotted origin, from a file's import statements.

    ``import numpy as np`` maps ``np -> numpy``; ``from time import
    perf_counter as pc`` maps ``pc -> time.perf_counter``.  Nested (lazy)
    imports are included: the rules here care about what a name *means*,
    not when it binds.
    """

    def __init__(self, tree: ast.Module):
        self.aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.expr) -> str | None:
        """Dotted origin of an expression like ``np.random.rand`` or
        ``pc`` — None when the base name is not an import alias."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        return ".".join([base] + list(reversed(parts)))


def _is_set_expr(node: ast.expr) -> bool:
    """Set literal, set comprehension, or a set()/frozenset() call."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    )


def _keyword(call: ast.Call, name: str) -> ast.keyword | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def _dict_view_call(node: ast.expr) -> str | None:
    """"items"/"values" when ``node`` is a no-arg ``<expr>.items()`` etc."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in ("items", "values", "keys")
        and not node.args
        and not node.keywords
    ):
        return node.func.attr
    return None


@register
class WallClockRule(Rule):
    """Simulated paths must never read real time.

    The serving simulator, tuner traces, fabric pricing, and telemetry
    exports all advance on the *simulated* clock; a stray
    ``time.time()`` makes seeded reruns diverge and un-pins every BENCH
    artifact.  Real-hardware paths (``launch/``, ``pipeline/runtime.py``,
    ``benchmarks/``) are allowlisted; ``telemetry.timed`` is the one
    sanctioned wall-clock instrument and carries explicit pragmas.
    """

    name = "wall-clock"
    description = "wall-clock read on a simulated path"

    WALL_TIME_FNS = {
        "time", "time_ns", "perf_counter", "perf_counter_ns",
        "monotonic", "monotonic_ns", "process_time", "process_time_ns",
        "clock_gettime",
    }
    DATETIME_FNS = {"now", "utcnow", "today"}
    #: module prefixes where wall-clock reads are the point
    ALLOW_MODULES = ("repro_torch.launch", "repro_torch.pipeline.runtime", "benchmarks")
    #: path shapes for the same allowlist (benchmarks/ is a namespace
    #: package, so its module names carry no package prefix)
    ALLOW_DIRS = ("launch", "benchmarks")

    def _allowlisted(self, ctx: FileContext) -> bool:
        if any(
            ctx.module == m or ctx.module.startswith(m + ".")
            for m in self.ALLOW_MODULES
        ):
            return True
        posix = ctx.path.as_posix()
        return any(d in ctx.path.parts for d in self.ALLOW_DIRS) or posix.endswith(
            "pipeline/runtime.py"
        )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if self._allowlisted(ctx):
            return
        imports = ImportMap(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = imports.resolve(node.func)
            if origin is None:
                continue
            if origin.startswith("time.") and origin.split(".", 1)[1] in self.WALL_TIME_FNS:
                yield self.finding(
                    ctx, node,
                    f"{origin}() reads the wall clock on a simulated path; "
                    "use the simulated clock (or telemetry.timed for profiling)",
                )
            elif (
                origin.startswith("datetime.")
                and origin.split(".")[-1] in self.DATETIME_FNS
            ):
                yield self.finding(
                    ctx, node,
                    f"{origin}() reads the wall clock on a simulated path",
                )


@register
class UnseededRandomRule(Rule):
    """All randomness must flow from an explicit seed.

    The global ``random`` module and the legacy ``numpy.random.*``
    function API draw from hidden process-global state; one call makes a
    "seeded" rerun irreproducible.  Use ``random.Random(seed)`` or
    ``numpy.random.default_rng(seed)`` / ``Generator(PCG64(seed))``.
    """

    name = "unseeded-random"
    description = "global / legacy RNG API instead of a seeded generator"

    ALLOWED_RANDOM = {"Random", "SystemRandom"}
    ALLOWED_NUMPY = {
        "default_rng", "Generator", "BitGenerator", "SeedSequence",
        "PCG64", "PCG64DXSM", "MT19937", "Philox", "SFC64",
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        imports = ImportMap(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = imports.resolve(node.func)
            if origin is None:
                continue
            if origin.startswith("random.") and "." not in origin[len("random.") :]:
                fn = origin.split(".", 1)[1]
                if fn not in self.ALLOWED_RANDOM:
                    yield self.finding(
                        ctx, node,
                        f"{origin}() uses the process-global RNG; "
                        "construct random.Random(seed) instead",
                    )
            elif origin.startswith("numpy.random.") or origin.startswith("np.random."):
                fn = origin.split(".")[-1]
                if fn not in self.ALLOWED_NUMPY:
                    yield self.finding(
                        ctx, node,
                        f"legacy numpy.random.{fn}() draws from global state; "
                        "use numpy.random.default_rng(seed)",
                    )


@register
class SetIterationRule(Rule):
    """Never iterate a set where order can matter.

    Set iteration order depends on insertion history and hash
    randomization of the element types; a ``for`` over a set feeding any
    stateful work is an iteration-order tie-break waiting to happen.
    Sort first (``for x in sorted(s)``) or keep a list.
    """

    name = "set-iteration"
    description = "for-loop / comprehension over an unordered set"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)) and _is_set_expr(node.iter):
                yield self.finding(
                    ctx, node.iter,
                    "iterating a set: order is not deterministic across "
                    "processes; wrap in sorted(...) or keep a list",
                )
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
                for gen in node.generators:
                    if _is_set_expr(gen.iter):
                        yield self.finding(
                            ctx, gen.iter,
                            "comprehension over a set: order is not "
                            "deterministic; wrap in sorted(...)",
                        )


@register
class UnkeyedSortRule(Rule):
    """Ordering decisions over dict views need a pinned total order.

    ``min``/``max``/``sorted`` over ``d.values()`` (or over ``d.items()``
    with a ``key=``) resolve ties by dict insertion order — which is
    whatever order the caller happened to build the dict in.  Pin the
    tie-break with an explicit total-order key, or annotate scalar
    aggregations (where ties are value-identical) with a pragma.
    """

    name = "unkeyed-sort"
    description = "min/max/sorted over a dict view with insertion-order ties"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("min", "max", "sorted")
                and node.args
            ):
                continue
            view = _dict_view_call(node.args[0])
            if view is None:
                continue
            kw = _keyword(node, "key")
            has_key = kw is not None and not self._key_includes_dict_key(kw.value)
            if view == "values":
                yield self.finding(
                    ctx, node,
                    f"{node.func.id}() over dict .values(): ties resolve by "
                    "insertion order; aggregate order-insensitively or sort "
                    "items with a total key",
                )
            elif view in ("items", "keys") and has_key:
                yield self.finding(
                    ctx, node,
                    f"{node.func.id}(..., key=...) over dict .{view}(): "
                    "equal keys fall back to insertion order; fold the "
                    "unique dict key into the sort key",
                )

    @staticmethod
    def _key_includes_dict_key(key: ast.expr) -> bool:
        """True when the sort key folds in the element's unique dict key
        (``lambda kv: (..., kv[0], ...)``), making the order total."""
        if not (isinstance(key, ast.Lambda) and key.args.args):
            return False
        arg = key.args.args[0].arg
        for node in ast.walk(key.body):
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == arg
                and isinstance(node.slice, ast.Constant)
                and node.slice.value == 0
            ):
                return True
        return False


@register
class TelemetryGuardRule(Rule):
    """Duck-typed telemetry handles must be guarded before use.

    Core/interconnect stay import-free of ``repro_torch.telemetry``, so their
    ``telemetry`` fields are plain ``object | None``.  The contract: bind
    to a local, check ``is not None`` (after ``live()`` normalization),
    then call — one branch on the hot path, and no AttributeError when a
    caller passes the NULL sink or nothing at all.
    """

    name = "telemetry-guard"
    severity = SEVERITY_WARNING
    description = "telemetry handle used without a live()/None guard"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.module.startswith("repro_torch.telemetry"):
            return  # the sink itself is concrete, not duck-typed
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(ctx, fn)

    def _check_function(self, ctx, fn) -> Iterator[Finding]:
        handles: set[str] = set()
        guard_lines: dict[str, int] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name) and self._is_handle_expr(node.value):
                    handles.add(tgt.id)
            if isinstance(node, (ast.If, ast.IfExp, ast.While, ast.Assert)):
                for name in self._guarded_names(node.test):
                    line = guard_lines.get(name)
                    guard_lines[name] = min(line, node.lineno) if line else node.lineno
        for node in ast.walk(fn):
            # direct chained use: self.telemetry.counter(...) — never OK,
            # it skips both the local bind and the guard
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "telemetry"
            ):
                yield self.finding(
                    ctx, node,
                    "chained use of a duck-typed .telemetry field; bind it "
                    "to a local and guard with `is not None` first",
                )
            # local-handle use before any guard on that name
            elif (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in handles
            ):
                guard = guard_lines.get(node.value.id)
                if guard is None or guard > node.lineno:
                    yield self.finding(
                        ctx, node,
                        f"telemetry handle `{node.value.id}` used without a "
                        "preceding `is not None` guard",
                    )

    @staticmethod
    def _is_handle_expr(value: ast.expr) -> bool:
        if isinstance(value, ast.Attribute) and value.attr == "telemetry":
            return True
        return (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id == "live"
        )

    @staticmethod
    def _guarded_names(test: ast.expr) -> Iterator[str]:
        for node in ast.walk(test):
            if isinstance(node, ast.Name):
                yield node.id


@register
class IdOrderingRule(Rule):
    """``id()`` is not an ordering.

    Object addresses vary run to run, so any ``id()``-based comparison or
    sort key is nondeterministic by construction.  Use an explicit index,
    name, or dataclass ordering instead.
    """

    name = "id-ordering"
    description = "id()-based ordering or comparison"

    ORDER_FNS = {"sorted", "min", "max", "nsmallest", "nlargest"}
    CMP_OPS = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                fname = None
                if isinstance(node.func, ast.Name):
                    fname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    fname = node.func.attr
                if fname in self.ORDER_FNS or fname == "sort":
                    kw = _keyword(node, "key")
                    if kw is not None and self._mentions_id(kw.value):
                        yield self.finding(
                            ctx, node,
                            "sort key built from id(): object addresses are "
                            "not stable across runs",
                        )
                if fname in ("heappush", "heappushpop") and any(
                    self._mentions_id(a) for a in node.args
                ):
                    yield self.finding(
                        ctx, node,
                        "heap entry ordered by id(): addresses are not a "
                        "stable total order; use a sequence number",
                    )
            elif isinstance(node, ast.Compare) and any(
                isinstance(op, self.CMP_OPS) for op in node.ops
            ):
                if any(
                    self._is_id_call(e) for e in [node.left] + list(node.comparators)
                ):
                    yield self.finding(
                        ctx, node,
                        "ordered comparison of id() values is nondeterministic",
                    )

    @staticmethod
    def _is_id_call(node: ast.expr) -> bool:
        return (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "id"
        )

    @classmethod
    def _mentions_id(cls, node: ast.expr) -> bool:
        if isinstance(node, ast.Name) and node.id == "id":
            return True
        return any(cls._is_id_call(n) for n in ast.walk(node))


@register
class FloatAccumRule(Rule):
    """Float accumulation over an unordered iterable is order-dependent.

    fp addition is not associative: ``sum({a, b, c})`` can differ in the
    last ulp between runs when set order shifts, breaking bit-for-bit
    rerun checks.  Sort first, or use ``math.fsum`` (correctly rounded,
    order-insensitive).
    """

    name = "float-accum"
    description = "sum() over a set — fp result depends on iteration order"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "sum"
                and node.args
            ):
                continue
            arg = node.args[0]
            if _is_set_expr(arg):
                yield self.finding(
                    ctx, node,
                    "sum() over a set: float addition is order-dependent; "
                    "sum(sorted(s)) or math.fsum",
                )
            elif isinstance(arg, ast.GeneratorExp) and any(
                _is_set_expr(g.iter) for g in arg.generators
            ):
                yield self.finding(
                    ctx, node,
                    "sum() of a generator over a set: float addition is "
                    "order-dependent; iterate sorted(...)",
                )


@register
class EventPastRule(Rule):
    """Events must never be scheduled behind the loop clock.

    ``EventLoop`` dispatches in (time, kind, push-order) order; pushing
    an event at ``t - dt`` from a handler running at ``t`` silently
    reorders the timeline (the event fires immediately but *after*
    everything already queued at earlier times was dropped).  Pattern:
    a ``.push(...)`` / ``._push(...)`` call site whose time argument is a
    subtraction or a negative constant.
    """

    name = "event-past"
    severity = SEVERITY_WARNING
    description = "event pushed at a time computed by subtraction"

    RECEIVERS = {"loop", "event_loop", "evloop", "_loop"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            if not self._is_loop_push(node.func):
                continue
            t = node.args[0]
            if isinstance(t, ast.BinOp) and isinstance(t.op, ast.Sub):
                yield self.finding(
                    ctx, node,
                    "event time is a subtraction — it may precede the loop "
                    "clock; schedule at `t` or `t + delay`",
                )
            elif (
                isinstance(t, ast.UnaryOp)
                and isinstance(t.op, ast.USub)
                or isinstance(t, ast.Constant)
                and isinstance(t.value, (int, float))
                and t.value < 0
            ):
                yield self.finding(
                    ctx, node, "event scheduled at a negative time"
                )

    def _is_loop_push(self, func: ast.expr) -> bool:
        if not isinstance(func, ast.Attribute):
            return False
        if func.attr == "_push":
            return True
        if func.attr != "push":
            return False
        recv = func.value
        if isinstance(recv, ast.Name):
            return recv.id in self.RECEIVERS
        return isinstance(recv, ast.Attribute) and recv.attr in self.RECEIVERS
