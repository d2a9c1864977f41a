"""The port stands alone: it imports neither JAX nor the JAX package.

The machine with the card has no JAX, so the port, its example and
``chip_smoke.py`` must not reach it, not even through a module of ``repro``
that is itself free of JAX.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
STANDALONE = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "examples" / "pipeline_serve_cnn_torch.py",
    ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "fabric_tour_torch.py",
    ROOT / "examples" / "power_tour_torch.py",
]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for mod in ("core.tuner", "kernels.im2col_conv", "models.cnn", "pipeline.runtime", "runtime.fault",
                "launch.serve_cnn", "kernels.flash_attention", "kernels.ssd_scan", "models.lm_common",
                "models.blocks", "models.transformer", "configs.granite3_2b", "launch.serve",
                "kernels.gemm", "core.baselines", "core.space", "optim.adamw", "optim.grad_compress",
                "data.pipeline", "checkpoint.store", "launch.train", "interconnect.fabric",
                "interconnect.topology", "power.model", "power.thermal", "telemetry.core", "telemetry.metrics",
                "telemetry.tracer", "faults.model", "faults.injector", "faults.resilience", "serve.traffic",
                "serve.simulator", "serve.autotuner", "sharding", "collectives", "models.layout",
                "launch.shardings", "launch.dryrun", "launch.hillclimb", "launch.sweep"):
        assert f"repro_torch.{mod}" in res["modules"]


def test_no_standalone_file_names_jax_or_repro_in_an_import():
    bad = []
    for path in STANDALONE:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA (as here) it exits non-zero and prints no result; alone in
    a directory it cannot find the port either."""
    for script in (ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py"):
        if script.parent == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True, cwd=script.parent, timeout=120,
            env={**_env(), "CUDA_VISIBLE_DEVICES": ""},
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
