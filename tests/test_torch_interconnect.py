"""The port's interconnect fabric against the JAX package's.

``repro_torch.interconnect`` is a copy of ``repro.interconnect``.  Built
from the same arguments in both packages (every preset, express channels,
memory-controller caps as a number, a mapping and ``"auto"``, links failed
and degraded), both must route and price alike, compared with ``==``: routes,
routed latencies, Yen's k shortest paths, static and adaptive flow times
with and without background flows, ``restrict`` and ``with_link_latency``.
The randomised properties are in ``tests/test_torch_fabric_properties.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro import core as jcore
from repro import interconnect as jic
from repro_torch import core
from repro_torch import interconnect as ic

ROOT = Path(__file__).resolve().parents[1]

#: (preset, positional args, keyword args, EPs bound to nodes 0..n-1)
PRESETS = {
    "mesh2x4": ("mesh2d", (2, 4), dict(bw=1e8, latency=1e-6), 8),
    "mesh3x3": ("mesh2d", (3, 3), dict(bw=1e8, latency=1e-6), 8),
    "mesh2x4+x2": ("mesh2d", (2, 4), dict(bw=1e8, latency=1e-6, express_bw=2e8), 8),
    "mesh2x5+x3": ("mesh2d", (2, 5), dict(bw=1e8, latency=1e-6, express_bw=3e8, express_latency=5e-7,
                                          express_stride=3), 8),
    "ring8": ("ring", (8,), dict(bw=1e8, latency=1e-6), 8),
    "ring6-slow": ("ring", (6,), dict(bw=1e8, latency=1e-6, segment_bws=(1e8, 2e7, 1e8, 1e8, 5e7, 1e8)), 6),
    "xbar8": ("crossbar", (8,), dict(bw=1e8, latency=1e-6), 8),
    "xbar4-ports": ("crossbar", (4,), dict(bw=1e8, latency=1e-6, port_bws=(1e8, 1e7, 1e8, 5e7)), 4),
    "hier2x4": ("hierarchical", (2, 4), {}, 8),
    "hier3x2": ("hierarchical", (3, 2), dict(intra_bw=4e10, inter_bw=1e10, inter_latency=1e-6), 6),
    "full8": ("fully_connected", (8,), {}, 8),
}
MC_BWS = {"none": None, "number": 5e7, "mapping": {0: 4e7, 3: 6e7, 5: 2e7}, "auto": "auto"}
NBYTES = (1e3, 1e5, 2e6)


def _pair(preset):
    fn, args, kw, n_eps = PRESETS[preset]
    return getattr(ic, fn)(*args, **kw), getattr(jic, fn)(*args, **kw), n_eps


def _links(topo):
    return {k: (v.bw, v.latency) for k, v in sorted(topo.links.items())}


def _fabrics(preset, mc, routing="static"):
    """The same fabric in both packages, attached to the paper's platform of
    as many EPs when ``mc`` is ``"auto"`` (the caps resolve at attach time)."""
    topo, jtopo, n_eps = _pair(preset)
    fab = ic.uniform_fabric(topo, n_eps, mc_bw=MC_BWS[mc], routing=routing)
    jfab = jic.uniform_fabric(jtopo, n_eps, mc_bw=MC_BWS[mc], routing=routing)
    if mc == "auto":
        fab = core.paper_platform(n_eps).with_fabric(fab).fabric
        jfab = jcore.paper_platform(n_eps).with_fabric(jfab).fabric
        assert fab.mc_bw == jfab.mc_bw and isinstance(fab.mc_bw, dict)
    return fab, jfab, n_eps


def _flows(mod, n_eps, n_nodes, seed, n=6, n_bg=2):
    """Seeded boundary flows between EPs, and background flows between nodes."""
    rng = np.random.default_rng(seed)
    flows = [mod.Flow(int(rng.integers(n_eps)), int(rng.integers(n_eps)), float(NBYTES[rng.integers(3)]))
             for _ in range(n)]
    bg = [mod.Flow(int(rng.integers(n_nodes)), int(rng.integers(n_nodes)), float(NBYTES[rng.integers(3)]), nodes=True)
          for _ in range(n_bg)]
    return flows, bg


def _outcome(fn, *args):
    """What a call returns, or the error it raises (a severed route raises)."""
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def _assert_fabric_prices_alike(fab, jfab, n_eps, seed=0):
    pairs = [(a, b) for a in range(n_eps) for b in range(n_eps)]
    assert [_outcome(fab.route_ep, a, b) for a, b in pairs] == [_outcome(jfab.route_ep, a, b) for a, b in pairs]
    assert [fab.latency_ep(a, b) for a, b in pairs] == [jfab.latency_ep(a, b) for a, b in pairs]
    n_nodes = fab.topology.n_nodes
    for s in range(3):
        flows, bg = _flows(ic, n_eps, n_nodes, seed + s)
        jflows, jbg = _flows(jic, n_eps, n_nodes, seed + s)
        for f, jf in ((flows, jflows), (flows + bg, jflows + jbg)):
            assert _outcome(fab.route_flows, f) == _outcome(jfab.route_flows, jf)
            assert fab.flow_times(f) == jfab.flow_times(jf)
        a, b, nbytes = flows[0].src, flows[0].dst, flows[0].nbytes
        assert fab.transfer_time(a, b, nbytes) == jfab.transfer_time(a, b, nbytes)
        assert fab.transfer_time(a, b, nbytes, background=bg) == jfab.transfer_time(a, b, nbytes, background=jbg)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_topology_matches_reference(preset):
    topo, jtopo, _ = _pair(preset)
    assert (topo.name, topo.n_nodes, topo.coords) == (jtopo.name, jtopo.n_nodes, jtopo.coords)
    assert _links(topo) == _links(jtopo)
    nodes = range(topo.n_nodes)
    for s in nodes:
        assert topo.neighbors(s) == jtopo.neighbors(s)
        for d in nodes:
            assert topo.route(s, d) == jtopo.route(s, d)
            assert topo.path_latency(s, d) == jtopo.path_latency(s, d)
            assert topo.hops(s, d) == jtopo.hops(s, d)
            if s != d:
                for k in (1, 3, 5):
                    assert topo.k_shortest_paths(s, d, k) == jtopo.k_shortest_paths(s, d, k)
    assert topo.components() == jtopo.components()


@pytest.mark.parametrize("routing", ["static", "adaptive"])
@pytest.mark.parametrize("mc", sorted(MC_BWS))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fabric_routes_and_prices_match_reference(preset, mc, routing):
    fab, jfab, n_eps = _fabrics(preset, mc, routing)
    _assert_fabric_prices_alike(fab, jfab, n_eps)


@pytest.mark.parametrize("routing", ["static", "adaptive"])
@pytest.mark.parametrize("preset", ["mesh2x4", "mesh2x4+x2", "ring8", "xbar8", "hier2x4"])
def test_failed_and_degraded_links_match_reference(preset, routing):
    fab, jfab, n_eps = _fabrics(preset, "number", routing)
    keys = sorted(fab.topology.links)
    for step, (op, key) in enumerate([("degrade", keys[0]), ("fail", keys[1]), ("fail", keys[-1]),
                                      ("restore", keys[1]), ("degrade", keys[2])]):
        for f in (fab, jfab):
            if op == "fail":
                f.fail_link(*key)
            elif op == "degrade":
                f.degrade_link(*key, 0.25)
            else:
                f.restore_link(*key)
        assert fab.fault_fingerprint() == jfab.fault_fingerprint()
        assert _links(fab.effective_topology()) == _links(jfab.effective_topology())
        assert fab.marooned_eps() == jfab.marooned_eps()
        _assert_fabric_prices_alike(fab, jfab, n_eps, seed=10 * step)


def test_link_faults_that_sever_a_route_price_inf_in_both():
    fab, jfab, n_eps = _fabrics("ring8", "none")
    for f in (fab, jfab):
        f.fail_link(0, 1)
        f.fail_link(3, 4)
    assert fab.latency_ep(1, 4) == jfab.latency_ep(1, 4) == float("inf")
    _assert_fabric_prices_alike(fab, jfab, n_eps)
    assert fab.effective_topology().components() == jfab.effective_topology().components()


@pytest.mark.parametrize("routing", ["static", "adaptive"])
@pytest.mark.parametrize("preset", ["mesh2x4", "mesh2x5+x3", "ring6-slow", "xbar4-ports", "hier3x2"])
def test_restrict_and_with_link_latency_match_reference(preset, routing):
    fab, jfab, n_eps = _fabrics(preset, "mapping", routing)
    keep = sorted({*range(0, n_eps, 2), n_eps - 1})
    sub, jsub = fab.restrict(keep), jfab.restrict(keep)
    assert sub.ep_nodes == jsub.ep_nodes
    _assert_fabric_prices_alike(sub, jsub, len(keep))
    for lat in (1e-7, 1e-4):
        slow, jslow = fab.with_link_latency(lat), jfab.with_link_latency(lat)
        assert _links(slow.topology) == _links(jslow.topology)
        _assert_fabric_prices_alike(slow, jslow, n_eps, seed=3)
    reseeded = fab.with_routing("adaptive", k_paths=2, max_sweeps=3, seed=5)
    jreseeded = jfab.with_routing("adaptive", k_paths=2, max_sweeps=3, seed=5)
    _assert_fabric_prices_alike(reseeded, jreseeded, n_eps, seed=7)


@pytest.mark.parametrize("conf", ["paper4", "paper8", "C1", "C2", "C3", "C4", "C5"])
def test_scalar_fabric_matches_reference(conf):
    plat = core.paper_platform(int(conf[5:])) if conf.startswith("paper") else core.table3_platform(conf)
    jplat = jcore.paper_platform(int(conf[5:])) if conf.startswith("paper") else jcore.table3_platform(conf)
    fab, jfab = ic.scalar_fabric(plat), jic.scalar_fabric(jplat)
    assert fab.topology.name == jfab.topology.name and _links(fab.topology) == _links(jfab.topology)
    _assert_fabric_prices_alike(fab, jfab, plat.n_eps)


def test_platform_fabric_knobs_match_reference():
    plat, jplat = core.paper_platform(8), jcore.paper_platform(8)
    fab = plat.with_fabric(ic.uniform_fabric(ic.mesh2d(2, 4, bw=1e8, latency=1e-6)))
    jfab = jplat.with_fabric(jic.uniform_fabric(jic.mesh2d(2, 4, bw=1e8, latency=1e-6)))
    assert fab == plat  # the fabric is excluded from comparison, as in the reference
    for lat in (1e-6, 1e-4, 1e-3):
        swept, jswept = fab.with_latency(lat), jfab.with_latency(lat)
        assert swept.name == jswept.name
        assert swept.fabric.latency_ep(0, 7) == jswept.fabric.latency_ep(0, 7)
        _assert_fabric_prices_alike(swept.fabric, jswept.fabric, 8)
    small, jsmall = fab.without([1, 6]), jfab.without([1, 6])
    assert small.name == jsmall.name and small.fabric.ep_nodes == jsmall.fabric.ep_nodes
    _assert_fabric_prices_alike(small.fabric, jsmall.fabric, 6)


def test_validation_matches_reference():
    for mod in (ic, jic):
        with pytest.raises(ValueError):
            mod.uniform_fabric(mod.mesh2d(2, 2), mc_bw="fast")
        with pytest.raises(ValueError):
            mod.uniform_fabric(mod.mesh2d(2, 2), routing="random")
        with pytest.raises(ValueError):
            mod.uniform_fabric(mod.mesh2d(2, 2), 5)
        with pytest.raises(ValueError):
            mod.Fabric(mod.mesh2d(2, 2), ep_nodes=(0, 4))
        with pytest.raises(ValueError):
            mod.mesh2d(2, 4, express_bw=1e9, express_stride=1)
        with pytest.raises(ValueError):
            mod.ring(2, segment_bws=(1.0, 2.0))
        with pytest.raises(ValueError):
            mod.crossbar(3, port_bws=(1.0,))
    with pytest.raises(ValueError):
        core.paper_platform(4).with_fabric(ic.uniform_fabric(ic.mesh2d(2, 4)))
    with pytest.raises(ValueError):
        jcore.paper_platform(4).with_fabric(jic.uniform_fabric(jic.mesh2d(2, 4)))


def test_fabric_tour_twin_prints_what_the_reference_prints():
    """Every line of the fabric tour is a function of the model alone."""
    out = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    for name in ("fabric_tour.py", "fabric_tour_torch.py"):
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)], capture_output=True, text=True,
                              env=env, timeout=300, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        out[name] = proc.stdout.splitlines()
    assert out["fabric_tour_torch.py"] == out["fabric_tour.py"]
    tags = {line.split("]")[0] + "]" for line in out["fabric_tour.py"]}
    assert {"[topo ]", "[route]", "[degen]", "[price]", "[fig9 ]", "[tune ]"} <= tags
