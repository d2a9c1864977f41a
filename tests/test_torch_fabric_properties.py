"""The port's fabric under ``tests/test_fabric_properties.py``'s seven
properties (Hypothesis), each also held equal to the JAX package's fabric
on the same drawn topology and flows, compared with ``==``:

  * the adaptive assignment is deterministic, across calls and instances;
  * it is a function of the flow multiset, not of the list order;
  * every route is a loopless walk of adjacent links;
  * Yen's k shortest paths are simple, distinct, sorted and headed by the
    shortest;
  * under static routing, adding a flow never speeds anyone up;
  * adaptive never prices a flow set worse in total than static;
  * where adaptive finds nothing better it keeps the static routes.

Runs under the fixed, derandomized Hypothesis profile from ``conftest.py``.
"""

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro import interconnect as jic
from repro_torch import interconnect as ic
from repro_torch.interconnect.topology import path_links

#: heterogeneous but well-conditioned link grades (bytes/s, s), as the
#: reference's property file draws them
_BW_GRADES = (1e6, 1e7, 5e7, 1e8, 1e9)
_LAT_GRADES = (0.0, 1e-7, 1e-6, 1e-4)
_NBYTES = (1e3, 1e5, 2e6)


@st.composite
def topology_specs(draw) -> tuple[int, dict]:
    """A random connected topology as plain data, ``(n_nodes, {(u, v): (bw,
    latency)})``, so both packages build it: a random spanning tree for
    connectivity, extra random edges for alternative paths."""
    n = draw(st.integers(min_value=2, max_value=7))
    link = st.tuples(st.sampled_from(_BW_GRADES), st.sampled_from(_LAT_GRADES))
    links = {}
    for v in range(1, n):
        u = draw(st.integers(min_value=0, max_value=v - 1))
        links[(u, v)] = draw(link)
    for _ in range(draw(st.integers(min_value=0, max_value=2 * n))):
        a = draw(st.integers(min_value=0, max_value=n - 1))
        b = draw(st.integers(min_value=0, max_value=n - 1))
        if a != b:
            links[(min(a, b), max(a, b))] = draw(link)
    return n, links


@st.composite
def specs_and_flows(draw) -> tuple[tuple[int, dict], list[tuple[int, int, float]]]:
    spec = draw(topology_specs())
    node = st.integers(min_value=0, max_value=spec[0] - 1)
    n_flows = draw(st.integers(min_value=1, max_value=8))
    return spec, [(draw(node), draw(node), draw(st.sampled_from(_NBYTES))) for _ in range(n_flows)]


def _topology(mod, spec):
    n, links = spec
    return mod.Topology(name=f"rand{n}", n_nodes=n, links={k: mod.Link(bw, lat) for k, (bw, lat) in links.items()})


def _fabric(mod, spec, routing, seed=0):
    return mod.Fabric(topology=_topology(mod, spec), ep_nodes=tuple(range(spec[0])), routing=routing, seed=seed)


def _flows(mod, flows):
    return [mod.Flow(src=s, dst=d, nbytes=b, nodes=True) for s, d, b in flows]


def _priced(spec, flows, routing, seed=0):
    """(routes, times) of the port's fabric, held equal to the reference's."""
    fab, jfab = _fabric(ic, spec, routing, seed), _fabric(jic, spec, routing, seed)
    ours = (fab.route_flows(_flows(ic, flows)), fab.flow_times(_flows(ic, flows)))
    assert ours == (jfab.route_flows(_flows(jic, flows)), jfab.flow_times(_flows(jic, flows)))
    return ours


@given(specs_and_flows(), st.sampled_from([0, 7]))
@settings(max_examples=60)
def test_adaptive_assignment_is_deterministic(sf, seed):
    spec, flows = sf
    fab = _fabric(ic, spec, "adaptive", seed)
    first = fab.route_flows(_flows(ic, flows))
    assert fab.route_flows(_flows(ic, flows)) == first
    assert fab.flow_times(_flows(ic, flows)) == fab.flow_times(_flows(ic, flows))
    assert _priced(spec, flows, "adaptive", seed)[0] == first  # a fresh instance, and the reference's


@given(specs_and_flows(), st.randoms(use_true_random=False))
@settings(max_examples=60)
def test_adaptive_assignment_is_a_function_of_the_flow_multiset(sf, rnd):
    spec, flows = sf
    perm = list(range(len(flows)))
    rnd.shuffle(perm)
    shuffled = [flows[i] for i in perm]
    routes, times = _priced(spec, flows, "adaptive")
    p_routes, p_times = _priced(spec, shuffled, "adaptive")
    assert sorted(zip(flows, routes, times)) == sorted(zip(shuffled, p_routes, p_times))
    if len(set(flows)) == len(flows):
        for j, i in enumerate(perm):
            assert p_routes[j] == routes[i] and p_times[j] == times[i]


def _assert_valid_walk(route, src, dst, links):
    if src == dst:
        assert route == ()
        return
    node, visited = src, {src}
    for u, v in route:
        assert (u, v) in links, f"route uses non-link {(u, v)}"
        assert node in (u, v), f"route {route} breaks at {node}"
        node = v if node == u else u
        assert node not in visited, f"route {route} revisits {node}"
        visited.add(node)
    assert node == dst


@given(specs_and_flows())
@settings(max_examples=60)
def test_routes_are_valid_loopless_walks(sf):
    spec, flows = sf
    for routing in ("static", "adaptive"):
        for (s, d, _), route in zip(flows, _priced(spec, flows, routing)[0]):
            _assert_valid_walk(route, s, d, spec[1])


@given(topology_specs(), st.integers(min_value=1, max_value=5))
@settings(max_examples=60)
def test_k_shortest_paths_are_simple_sorted_and_start_with_the_shortest(spec, k):
    topo, jtopo = _topology(ic, spec), _topology(jic, spec)
    for s in range(topo.n_nodes):
        for d in range(topo.n_nodes):
            if s == d:
                continue
            paths = topo.k_shortest_paths(s, d, k)
            assert paths == jtopo.k_shortest_paths(s, d, k)
            assert 1 <= len(paths) <= k and len(set(paths)) == len(paths)
            costs = []
            for p in paths:
                assert p[0] == s and p[-1] == d and len(set(p)) == len(p)
                _assert_valid_walk(path_links(p), s, d, spec[1])
                costs.append(topo._path_cost(p))
            assert costs == sorted(costs)
            assert costs[0][0] <= topo.path_latency(s, d) + 1e-15


@given(specs_and_flows())
@settings(max_examples=60)
def test_static_contention_is_monotone(sf):
    spec, flows = sf
    for cut in range(1, len(flows)):
        before = _priced(spec, flows[:cut], "static")[1]
        after = _priced(spec, flows[: cut + 1], "static")[1]
        for b, a in zip(before, after):
            assert a >= b - 1e-12 * max(1.0, b)


@given(specs_and_flows(), st.sampled_from([0, 3, 11]))
@settings(max_examples=60)
def test_adaptive_total_cost_never_exceeds_static(sf, seed):
    spec, flows = sf
    assert sum(_priced(spec, flows, "adaptive", seed)[1]) <= sum(_priced(spec, flows, "static")[1])


@given(specs_and_flows())
@settings(max_examples=30)
def test_adaptive_tie_keeps_the_static_assignment(sf):
    spec, flows = sf
    s_routes, s_times = _priced(spec, flows, "static")
    a_routes, a_times = _priced(spec, flows, "adaptive")
    if sum(a_times) == sum(s_times):
        assert a_routes == s_routes
