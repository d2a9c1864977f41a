"""The port's linter against the JAX package's, and the port's own gate.

``repro_torch.analysis`` is a copy of ``repro.analysis`` (shisha-lint) that
roots module names at ``repro_torch`` where the reference's roots them at
``repro``: the layering contracts, the wall-clock allowlist by module name
and the ``telemetry-guard`` exemption then hold the port's own packages,
which the reference's linter sees as modules of no package.  Each of the 17
tests of ``tests/test_analysis.py`` is mirrored here, on the reference's
fixtures in ``tests/fixtures/lint/`` (read only).  The layering and cycle
trees are copied into ``tmp_path`` with their ``repro`` path part and
imports renamed ``repro_torch``, and on every fixture the port's report
equals the reference's rule for rule and line for line, module names
mapped.  The gate lints ``src/repro_torch``: no finding, every pragma
load-bearing.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro import analysis as janalysis
from repro.analysis import cli as jcli
from repro_torch.analysis import RULES, lint_source, run
from repro_torch.analysis.cli import main
from repro_torch.analysis.framework import BAD_PRAGMA, USELESS_SUPPRESSION, parse_pragmas, source_context
from repro_torch.analysis.layering import collect_edges

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lint"
REPO = Path(__file__).resolve().parents[1]
PORT_SRC = REPO / "src" / "repro_torch"

PRAGMA_RE = re.compile(r"\s*#\s*shisha:\s*allow\(([^)]*)\)")
#: the port's pragmas: ``telemetry.timed``'s two clock reads, and the
#: fabric's sort of its flows by a key the rule cannot see is total
PORT_PRAGMAS = {("telemetry/core.py", 50): ("wall-clock",), ("telemetry/core.py", 54): ("wall-clock",),
                ("interconnect/fabric.py", 367): ("unkeyed-sort",)}

RULE_FIXTURES = [
    ("wall-clock", "wall_clock"),
    ("unseeded-random", "unseeded_random"),
    ("set-iteration", "set_iteration"),
    ("unkeyed-sort", "unkeyed_sort"),
    ("telemetry-guard", "telemetry_guard"),
    ("id-ordering", "id_ordering"),
    ("float-accum", "float_accum"),
    ("event-past", "event_past"),
    ("wall-clock", "thermal_accum"),
    ("float-accum", "thermal_accum"),
    ("unseeded-random", "mtbf_sampler"),
]


def _port_tree(src: Path, dst: Path) -> Path:
    """``src`` copied to ``dst`` with every ``repro`` path part and every
    ``repro`` import renamed ``repro_torch``: the same tree, rooted at the
    port's package."""
    for f in sorted(src.rglob("*")):
        if f.is_dir():
            continue
        rel = Path(*("repro_torch" if p == "repro" else p for p in f.relative_to(src).parts))
        out = dst / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(re.sub(r"^(from|import) repro\b", r"\1 repro_torch", f.read_text(), flags=re.M))
    return dst


def _mapped(report, root: Path) -> dict:
    """A report's findings and suppressions, each path relative to ``root``
    and every ``repro_torch`` read as ``repro``."""

    def one(f):
        path = Path(f.path).resolve()
        rel = path.relative_to(root.resolve()).as_posix() if path.is_relative_to(root.resolve()) else f.path
        return (rel.replace("repro_torch", "repro"), f.line, f.col, f.rule, f.severity,
                f.message.replace("repro_torch", "repro"))

    return {"findings": [one(f) for f in report.findings], "suppressed": [one(f) for f in report.suppressed]}


def _same_as_reference(report, root: Path, ref_path: Path, ref_root: Path = FIXTURES) -> None:
    """``report`` (of a tree under ``root``) is the reference linter's on
    ``ref_path`` (under ``ref_root``), module names mapped."""
    assert _mapped(report, root) == _mapped(janalysis.run([ref_path]), ref_root)


# -- registry shape ----------------------------------------------------------


def test_registry_covers_the_contracts_as_the_reference():
    names = set(RULES)
    assert len(names) >= 8
    assert {r for r, _ in RULE_FIXTURES} | {"import-layering"} <= names
    assert {n: (r.severity, r.description) for n, r in RULES.items()} == {
        n: (r.severity, r.description) for n, r in janalysis.RULES.items()}


# -- per-rule fixtures -------------------------------------------------------


@pytest.mark.parametrize("rule,stem", RULE_FIXTURES)
def test_rule_fires_on_bad_fixture(rule, stem):
    path = FIXTURES / f"{stem}_bad.py"
    report = run([path])
    fired = [f for f in report.findings if f.rule == rule]
    assert fired, f"{rule} did not fire on its bad fixture"
    assert all(f.line > 0 and f.path.endswith(f"{stem}_bad.py") for f in fired)
    _same_as_reference(report, FIXTURES, path)


@pytest.mark.parametrize("rule,stem", RULE_FIXTURES)
def test_clean_fixture_is_fully_clean(rule, stem):
    path = FIXTURES / f"{stem}_clean.py"
    report = run([path])
    assert report.findings == [], [f.format() for f in report.findings]
    _same_as_reference(report, FIXTURES, path)


# -- layering ----------------------------------------------------------------


def test_layering_contract_violations(tmp_path):
    tree = _port_tree(FIXTURES / "layering_bad", tmp_path / "layering_bad")
    report = run([tree])
    msgs = [f.message for f in report.findings if f.rule == "import-layering"]
    assert len(msgs) == 2
    assert any("repro_torch.telemetry may not import repro_torch.serve" in m for m in msgs)
    assert any("repro_torch.core may not import repro_torch.interconnect" in m and "lazily" in m for m in msgs)
    _same_as_reference(report, tree, FIXTURES / "layering_bad", FIXTURES / "layering_bad")
    # the untouched tree names the JAX package, which the port's contracts do not govern
    assert run([FIXTURES / "layering_bad"]).findings == []


def test_layering_clean_tree(tmp_path):
    tree = _port_tree(FIXTURES / "layering_clean", tmp_path / "layering_clean")
    report = run([tree])
    assert report.findings == []
    _same_as_reference(report, tree, FIXTURES / "layering_clean", FIXTURES / "layering_clean")


def test_import_cycle_detected(tmp_path):
    tree = _port_tree(FIXTURES / "cycle", tmp_path / "cycle")
    report = run([tree])
    cyc = [f for f in report.findings if f.rule == "import-layering"]
    assert len(cyc) == 1
    assert "mod_a -> mod_b -> mod_a" in cyc[0].message
    _same_as_reference(report, tree, FIXTURES / "cycle", FIXTURES / "cycle")


def test_lazy_import_is_not_a_cycle():
    a = "def get():\n    import mod_b\n    return mod_b\n"
    edges = collect_edges(source_context(a, module="mod_a"))
    assert [e.lazy for e in edges] == [True]


def test_port_layering_catches_a_core_module_importing_serve(tmp_path):
    """A port ``core`` module importing ``repro_torch.serve`` at module scope
    is a finding of the port's linter; the reference's sees no package in
    ``repro_torch`` and lets it through."""
    bad = tmp_path / "src" / "repro_torch" / "core" / "leak.py"
    bad.parent.mkdir(parents=True)
    bad.write_text('"""A core module that pulls the serving stack in."""\nfrom repro_torch.serve import co_serve  # noqa: F401\n')
    lazy = tmp_path / "src" / "repro_torch" / "core" / "lazy.py"
    lazy.write_text('"""Lazily: still not an allowed package."""\n\n\ndef f():\n    from repro_torch import serve\n'
                    "    return serve\n")
    fine = tmp_path / "src" / "repro_torch" / "core" / "fabric_user.py"
    fine.write_text('"""Lazily allowed."""\n\n\ndef f():\n    from repro_torch import interconnect\n'
                    "    return interconnect\n")
    report = run([tmp_path / "src"])
    found = sorted((Path(f.path).name, f.line, f.message) for f in report.findings)
    assert found == [("lazy.py", 5, "repro_torch.core may not import repro_torch.serve"),
                     ("leak.py", 2, "repro_torch.core may not import repro_torch.serve")]
    assert janalysis.run([tmp_path / "src"]).findings == []


# -- suppression pragmas -----------------------------------------------------


def test_pragma_suppresses_and_is_load_bearing():
    src = (FIXTURES / "suppression_ok.py").read_text()
    report = lint_source(src, display="suppression_ok.py")
    assert report.findings == []
    assert [f.rule for f in report.suppressed] == ["wall-clock"]
    stripped = PRAGMA_RE.sub("", src)
    report = lint_source(stripped, display="suppression_ok.py")
    assert [f.rule for f in report.findings] == ["wall-clock"]
    ref = janalysis.lint_source(stripped, display="suppression_ok.py")
    assert [f.to_json() for f in report.findings] == [f.to_json() for f in ref.findings]


def test_useless_pragma_is_an_error():
    report = run([FIXTURES / "suppression_useless.py"])
    assert [f.rule for f in report.findings] == [USELESS_SUPPRESSION]
    _same_as_reference(report, FIXTURES, FIXTURES / "suppression_useless.py")


def test_unknown_rule_in_pragma_is_an_error():
    report = lint_source("x = 1  # shisha: allow(no-such-rule)\n")
    assert [f.rule for f in report.findings] == [BAD_PRAGMA]


def test_pragma_mentions_in_docstrings_are_inert():
    report = lint_source('"""docs say # shisha: allow(wall-clock)."""\nx = 1\n')
    assert report.findings == []
    assert report.suppressed == []


# -- the port's tree-clean gate ----------------------------------------------


def test_src_tree_is_clean():
    report = run([PORT_SRC])
    assert report.findings == [], [f.format() for f in report.findings]
    used = {(Path(f.path).relative_to(PORT_SRC).as_posix(), f.line): f.rule for f in report.suppressed}
    assert used == {k: v[0] for k, v in PORT_PRAGMAS.items()}


def test_cli_gate_exits_zero_on_src(capsys):
    assert main([str(PORT_SRC)]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s), 0 warning(s), 3 suppressed" in proc.stdout
    assert "jax" not in proc.stdout


def test_cli_json_report_and_exit_codes(tmp_path, capsys):
    out = tmp_path / "lint.json"
    rc = main([str(FIXTURES / "wall_clock_bad.py"), "--format=json", "--output", str(out)])
    capsys.readouterr()
    assert rc == 1
    payload = json.loads(out.read_text())
    assert payload["tool"] == "shisha-lint"
    assert payload["summary"]["errors"] >= 1
    assert all(f["rule"] == "wall-clock" for f in payload["findings"])
    ref_out = tmp_path / "ref.json"
    assert jcli.main([str(FIXTURES / "wall_clock_bad.py"), "--format=json", "--output", str(ref_out)]) == 1
    capsys.readouterr()
    assert json.loads(ref_out.read_text()) == payload
    rc = main([str(FIXTURES / "wall_clock_bad.py"), "--report-only"])
    capsys.readouterr()
    assert rc == 0


def _module_for(py: Path) -> str:
    return ".".join(py.relative_to(PORT_SRC.parent).with_suffix("").parts).removesuffix(".__init__")


def test_every_pragma_in_src_is_load_bearing():
    """Deleting any single suppression pragma of the port must fail the gate."""
    checked = {}
    for py in sorted(PORT_SRC.rglob("*.py")):
        src = py.read_text()
        lines = src.splitlines(keepends=True)
        for pragma in parse_pragmas(src):
            i = pragma.line - 1
            mutated = "".join(PRAGMA_RE.sub("", l) if j == i else l for j, l in enumerate(lines))
            report = lint_source(mutated, display=str(py), module=_module_for(py))
            resurfaced = [f for f in report.findings if f.rule in pragma.rules]
            assert resurfaced, (f"{py}:{pragma.line}: pragma allow({', '.join(pragma.rules)}) suppresses nothing — "
                                "the gate would not notice its deletion")
            checked[(py.relative_to(PORT_SRC).as_posix(), pragma.line)] = pragma.rules
    assert checked == PORT_PRAGMAS


def test_report_is_deterministic_and_the_reference_on_every_fixture(tmp_path):
    tree = _port_tree(FIXTURES, tmp_path / "lint")
    a, b = run([tree]), run([tree])
    assert [f.to_json() for f in a.findings] == [f.to_json() for f in b.findings]
    assert [f.to_json() for f in a.suppressed] == [f.to_json() for f in b.suppressed]
    assert a.findings
    _same_as_reference(a, tree, FIXTURES)
    # the shipped src/ seen by both: the port's tree is clean under either linter
    assert janalysis.run([PORT_SRC]).findings == []


def test_port_linter_lints_itself_stdlib_only(tmp_path):
    """``repro_torch.analysis`` is stdlib-only and imports nothing internal:
    a third-party import or an internal one in a copy of it is a finding."""
    pkg = shutil.copytree(PORT_SRC / "analysis", tmp_path / "repro_torch" / "analysis")
    assert run([tmp_path]).findings == []
    (pkg / "extra.py").write_text('"""Not allowed here."""\nimport numpy  # noqa: F401\nfrom repro_torch import core  # noqa: F401\n')
    msgs = sorted(f.message for f in run([tmp_path]).findings)
    assert msgs == ["repro_torch.analysis is stdlib-only but imports 'numpy'",
                    "repro_torch.analysis may not import repro_torch.core"]
