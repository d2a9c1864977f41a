"""The port's power model against the JAX package's.

``repro_torch.power`` is a copy of ``repro.power``.  Fed the same
platforms and the same sequence of level changes, both must give the same
ladders, package watts, cap decisions and errors, and restrict alike
(through ``Platform.without`` too), compared with ``==``.  The tuner's DVFS
moves are held in ``tests/test_torch_core.py``.  The reference's thermal RC
model is not in the port yet: it comes with the serving layer that steps it.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro import core as jcore
from repro import power as jpw
from repro_torch import core
from repro_torch import power as pw
from repro_torch.pipeline.hetero import h100_platform_from_streams

ROOT = Path(__file__).resolve().parents[1]
PLATFORMS = ["paper4", "paper8", "C1", "C2", "C3", "C4", "C5", "h100x4"]


def _platforms(name):
    if name.startswith("paper"):
        return core.paper_platform(int(name[5:])), jcore.paper_platform(int(name[5:]))
    if name.startswith("h100"):
        # the same EPs in the reference's Platform type
        plat = h100_platform_from_streams(int(name[5:]), props=_H100)
        eps = tuple(jcore.EP(**dataclasses.asdict(e)) for e in plat.eps)
        return plat, jcore.Platform(name=plat.name, eps=eps)
    return core.table3_platform(name), jcore.table3_platform(name)


class _H100:
    name, multi_processor_count, total_memory = "cpu-as-H100", 132, 80 * 2**30


def _levels(spec):
    return [dataclasses.astuple(level) for level in spec.levels]


def _state(pm):
    n = pm.n_eps
    return (pm.snapshot(), pm.tunable, pm.cap_w, pm.static_package_w,
            [(pm.scale(e), pm.dynamic_w(e), pm.static_w(e), pm.can_step_up(e), pm.can_step_down(e))
             for e in range(n)])


@pytest.mark.parametrize("n_levels,min_scale", [(1, 0.4), (2, 0.5), (4, 0.4), (6, 0.25), (3, 1.0)])
def test_dvfs_ladder_matches_reference(n_levels, min_scale):
    ours = pw.dvfs_ladder(12.5, 1.875, n_levels=n_levels, min_scale=min_scale)
    theirs = jpw.dvfs_ladder(12.5, 1.875, n_levels=n_levels, min_scale=min_scale)
    assert [dataclasses.astuple(l) for l in ours] == [dataclasses.astuple(l) for l in theirs]


@pytest.mark.parametrize("factory", ["uniform", "uniform_capped", "uniform_6", "degenerate"])
@pytest.mark.parametrize("name", PLATFORMS)
def test_package_arithmetic_and_stepping_match_reference(name, factory):
    plat, jplat = _platforms(name)
    kw = {"uniform": {}, "uniform_capped": dict(cap_w=40.0), "uniform_6": dict(n_levels=6, min_scale=0.3),
          "degenerate": {}}[factory]
    make = "degenerate_power" if factory == "degenerate" else "uniform_power"
    pm, jpm = getattr(pw, make)(plat, **kw), getattr(jpw, make)(jplat, **kw)
    assert [_levels(s) for s in pm.specs] == [_levels(s) for s in jpm.specs]
    assert _state(pm) == _state(jpm)
    rng = np.random.default_rng(len(name))
    n = plat.n_eps
    for _ in range(20):
        ep = int(rng.integers(n))
        idx = int(rng.integers(len(pm.specs[ep].levels)))
        pm.set_level(ep, idx)
        jpm.set_level(ep, idx)
        in_use = [int(e) for e in rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False)]
        assert pm.package_w(in_use) == jpm.package_w(in_use)
        assert pm.cap_feasible(in_use) == jpm.cap_feasible(in_use)
        assert _state(pm) == _state(jpm)
    snap = pm.snapshot()
    pm.restore([0] * n)
    jpm.restore([0] * n)
    assert _state(pm) == _state(jpm)
    pm.restore(snap)
    assert pm.snapshot() == snap


def test_validation_matches_reference():
    for mod in (pw, jpw):
        level = mod.DVFSLevel("L0", 1.0, 1.0, 0.1)
        for bad in (dict(scale=0.0), dict(scale=1.5), dict(dynamic_w=-1.0), dict(static_w=-0.1)):
            with pytest.raises(ValueError):
                dataclasses.replace(level, **bad)
        slow = mod.DVFSLevel("L1", 0.5, 0.2, 0.05)
        with pytest.raises(ValueError):
            mod.EPPowerSpec(levels=())
        with pytest.raises(ValueError):
            mod.EPPowerSpec(levels=(slow, level))  # not fastest first
        with pytest.raises(ValueError):
            mod.EPPowerSpec(levels=(level, slow), nominal=2)
        with pytest.raises(ValueError):
            mod.PowerModel(specs=())
        spec = mod.EPPowerSpec(levels=(level, slow))
        pm = mod.PowerModel(specs=(spec, spec))
        with pytest.raises(ValueError):
            pm.set_level(0, 2)
        with pytest.raises(ValueError):
            pm.restore((0,))
        with pytest.raises(ValueError):
            mod.dvfs_ladder(1.0, 0.1, n_levels=0)
        with pytest.raises(ValueError):
            mod.dvfs_ladder(1.0, 0.1, min_scale=0.0)
    for c, mod in ((core, pw), (jcore, jpw)):
        with pytest.raises(ValueError):
            c.paper_platform(4).with_power(mod.uniform_power(c.paper_platform(8)))


@pytest.mark.parametrize("keep", [[1, 2], [0, 3], [3], [0, 1, 2, 3]])
def test_restrict_and_platform_without_carry_levels_as_the_reference(keep):
    out = []
    for c, mod in ((core, pw), (jcore, jpw)):
        plat = c.paper_platform(4)
        pm = mod.uniform_power(plat, cap_w=100.0)
        pm.set_level(2, 1)
        pm.set_level(3, 3)
        sub = pm.restrict(keep)
        dead = [i for i in range(4) if i not in keep]
        smaller = plat.with_power(pm).without(dead)
        out.append((_state(sub), smaller.name, _state(smaller.power),
                    [dataclasses.astuple(e) for e in smaller.eps]))
    assert out[0] == out[1]
    assert out[0][0][0] == tuple((0, 0, 1, 3)[i] for i in keep)


def test_power_tour_twin_prints_what_the_reference_prints_at_stops_1_to_4():
    """The twin stops where the serving layer starts (stops 5-6); every line
    before that is a function of the model alone."""
    out = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    for name in ("power_tour.py", "power_tour_torch.py"):
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)], capture_output=True, text=True,
                              env=env, timeout=300, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        out[name] = proc.stdout.splitlines()
    ours, theirs = out["power_tour_torch.py"], out["power_tour.py"]
    assert ours == theirs[: len(ours)]
    assert [line[:7] for line in ours if not line.startswith("[power]   ")] == [
        "[power]", "[power]", "[degen]", "[dvfs ]", "[cap  ]"]
    assert theirs[len(ours)].startswith("[serve]")
