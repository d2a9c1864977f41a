"""The port's power model against the JAX package's.

``repro_torch.power`` is a copy of ``repro.power``.  Fed the same
platforms and the same sequence of level changes, both must give the same
ladders, package watts, cap decisions and errors, and restrict alike
(through ``Platform.without`` too), compared with ``==``; the thermal RC
model the same trajectories, latches and throttle counts.  The tuner's DVFS
moves are held in ``tests/test_torch_core.py``, the serving layer that steps
the thermal model in ``tests/test_torch_serve.py``; ``co_serve`` over a
degenerate power model is here.
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
    """Every stop, 1-4 (the model alone) and 5-6 (serving with the thermal
    model live, and a throttle answered by a DVFS step-down): the twin prints
    what the reference tour prints, line for line."""
    out = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    for name in ("power_tour.py", "power_tour_torch.py"):
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)], capture_output=True, text=True,
                              env=env, timeout=300, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        out[name] = proc.stdout.splitlines()
    ours, theirs = out["power_tour_torch.py"], out["power_tour.py"]
    assert ours == theirs
    assert [line[:7] for line in ours if not line.startswith("[power]   ")] == [
        "[power]", "[power]", "[degen]", "[dvfs ]", "[cap  ]", "[serve]", "[heat ]", "[heat ]"]
    assert "'throttle'" in ours[-2]


def _thermal_state(th):
    return (list(th.temps), list(th.throttled), th.throttle_events, [th.factor(e) for e in range(th.n_eps)],
            th.electrical_derate)


@pytest.mark.parametrize("seed,n", [(5, 3), (1, 4), (3, 8)])
def test_thermal_trajectory_matches_reference(seed, n):
    ours, theirs = pw.uniform_thermal(n, seed=seed), jpw.uniform_thermal(n, seed=seed)
    assert (ours.r_k_per_w, ours.c_j_per_k) == (theirs.r_k_per_w, theirs.c_j_per_k)
    rng = np.random.default_rng(seed)
    for _ in range(300):
        ep, watts, dt = int(rng.integers(n)), float(rng.uniform(0.0, 40.0)), float(rng.uniform(0.1, 2.0))
        assert ours.step(ep, watts, dt) == theirs.step(ep, watts, dt)
        assert _thermal_state(ours) == _thermal_state(theirs)
    keep = [e for e in range(n) if e % 2 == 0]
    assert _thermal_state(ours.restrict(keep)) == _thermal_state(theirs.restrict(keep))


def test_thermal_hysteresis_matches_reference():
    """``tests/test_power.py``'s heat, cool and re-heat cycle, step by step."""
    states = []
    for mod in (pw, jpw):
        th = mod.ThermalModel(r_k_per_w=(5.0,), c_j_per_k=(2.0,), t_hot_c=85.0, t_cool_c=75.0)
        trail = [th.step(0, 12.0, 1.0) for _ in range(60)]
        while th.throttled[0]:
            trail.append(th.step(0, 0.0, 1.0))
        trail += [th.step(0, 12.0, 1.0) for _ in range(60)]
        states.append((trail, _thermal_state(th)))
    assert states[0] == states[1]
    assert states[0][1][2] == 2  # two engagements


def test_thermal_validation_and_attachment_match_reference():
    for mod in (pw, jpw):
        for bad in (lambda: mod.ThermalModel(r_k_per_w=(1.0,), c_j_per_k=(1.0, 2.0)),
                    lambda: mod.ThermalModel(r_k_per_w=(), c_j_per_k=()),
                    lambda: mod.ThermalModel(r_k_per_w=(1.0,), c_j_per_k=(1.0,), t_hot_c=70.0, t_cool_c=80.0),
                    lambda: mod.ThermalModel(r_k_per_w=(1.0,), c_j_per_k=(1.0,), throttle_derate=0.5),
                    lambda: mod.uniform_thermal(0)):
            with pytest.raises(ValueError):
                bad()
    out = []
    for c, mod in ((core, pw), (jcore, jpw)):
        plat = c.paper_platform(4)
        with pytest.raises(ValueError):
            mod.uniform_power(plat, thermal=mod.uniform_thermal(3))
        th = mod.uniform_thermal(4, seed=2)
        for e in range(4):
            th.step(e, 30.0 + e, 5.0)
        pm = mod.uniform_power(plat, thermal=th)
        smaller = plat.with_power(pm).without([1])
        out.append((_thermal_state(pm.restrict([0, 3]).thermal), _thermal_state(smaller.power.thermal),
                    smaller.power.thermal is not th, mod.degenerate_power(plat).thermal))
    assert out[0] == out[1]
    assert out[0][2:] == (True, None)



def _co_serve_powered(pkgs, powered: bool):
    """``tests/test_power.py``'s two-tenant co-serve on ``paper_platform(4)``,
    bare or with ``degenerate_power``; ``pkgs`` is (core, power, cnn, serve)."""
    c, p, cnn, sv = pkgs
    plat = c.paper_platform(4)
    horizon = 20.0
    tenants = [
        sv.Tenant(name="synthnet", layers=tuple(cnn.network_layers("synthnet")), slo=2.7,
                  traffic=sv.ReplayTraffic.record(sv.PoissonTraffic(rate=2.0, seed=11), horizon)),
        sv.Tenant(name="resnet50", layers=tuple(cnn.network_layers("resnet50")), slo=2.0,
                  traffic=sv.ReplayTraffic.record(sv.PoissonTraffic(rate=1.0, seed=12), horizon)),
    ]
    return sv.co_serve(plat.with_power(p.degenerate_power(plat)) if powered else plat, tenants, horizon=horizon,
                       elastic=False)


def test_co_serve_degenerate_power_is_bit_for_bit_and_the_reference():
    """``co_serve`` with ``degenerate_power`` serves the bare run's latencies
    and completions, and gives the reference's ``CoServeResult``."""
    from repro import serve as jserve
    from repro.models import cnn as jcnn
    from repro_torch import serve
    from repro_torch.models import cnn

    port, ref = (core, pw, cnn, serve), (jcore, jpw, jcnn, jserve)
    bare, powered = _co_serve_powered(port, False), _co_serve_powered(port, True)
    for rb, rp in zip(bare.results, powered.results):
        assert rb.sim.latencies == rp.sim.latencies
        assert rb.sim.n_completed == rp.sim.n_completed
        assert rb.sim.power is None and rp.sim.power is not None
    assert powered.aggregate_energy_j is not None and powered.joules_per_request > 0
    for powered_ in (False, True):
        ours, theirs = _co_serve_powered(port, powered_), _co_serve_powered(ref, powered_)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
