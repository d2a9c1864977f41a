"""Contention-priced communication over a chiplet :class:`Topology`.

A :class:`Fabric` binds EP indices to topology nodes and prices transfers
under a *steady-state flow set*: in a pipelined execution every stage
boundary ships activations once per beat, so all boundary transfers (plus
any co-tenant traffic) are concurrently in flight.  Two contention effects
are modeled, both deliberately simple and monotone:

  * **fair-share links** — ``k`` flows routed through one link each get
    ``bw / k`` of it (round-robin arbitration at the router); a flow's
    effective bandwidth is the minimum fair share along its route.  This is
    the graph version of the paper's "shared memory controller" effect
    (§6): co-located traffic slows everyone on the shared resource.
  * **memory-controller hotspots** — when ``mc_bw`` is set, every flow also
    queues at its endpoint nodes' memory controllers: ``k`` flows sourcing
    or sinking at one node share ``mc_bw`` there, so fan-in to a single
    chiplet saturates even over disjoint links.

Transfer time of a flow carrying ``nbytes`` is then

    ``nbytes / eff_bw + sum(link latencies along the route)``

which degenerates to the scalar model (``nbytes / bw + latency``) on a
fully-connected single-hop fabric with no concurrent flows — bit-for-bit,
which is what keeps all pre-fabric results unchanged (see
:func:`scalar_fabric` and the regression tests in
``tests/test_interconnect.py`` and ``tests/test_torch_interconnect.py``).
Adding a flow can only increase link and node loads, so contention is
monotone under static routing: no existing flow ever speeds up.

Routing itself is a decision, not just a price.  With ``routing="static"``
(the default) every flow takes the topology's fixed XY/Dijkstra route and
everything above holds unchanged.  With ``routing="adaptive"`` the fabric
assigns each flow a path from its :meth:`Topology.k_shortest_paths`
candidates to minimize that flow's *contention-priced* cost given where
every other flow currently runs — iterated best response over the whole
flow set, swept in deterministic order with seeded tie-breaks and a bounded
number of sweeps, so the assignment is a pure function of (topology, flow
multiset, seed).  The final assignment is kept only if its total priced
cost is no worse than the all-static assignment (ties keep static), so
adaptive routing can never lose to static on the same flow set — the
invariant the property suite pins.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Sequence

from .topology import Link, LinkKey, Topology, fully_connected


@dataclasses.dataclass(frozen=True)
class Flow:
    """One steady-state transfer: ``nbytes`` shipped ``src`` -> ``dst``.

    ``src``/``dst`` are EP indices of the pricing platform by default;
    ``nodes=True`` marks them as raw topology node ids — the form
    cross-tenant background flows take, since a tenant's restricted fabric
    keeps the *global* topology and co-tenant traffic lives outside the
    tenant's own EP index space.
    """

    src: int
    dst: int
    nbytes: float
    nodes: bool = False


@dataclasses.dataclass(eq=False)
class Fabric:
    """A topology plus the EP -> node binding and the contention model.

    ``ep_nodes[i]`` is the router node EP ``i`` sits on.  Restricting a
    fabric to a subset of EPs (:meth:`restrict`) keeps the full topology —
    a dead or foreign chiplet's router still forwards traffic — and only
    narrows the binding, so sub-platform routes are physically identical to
    global ones.
    """

    topology: Topology
    #: EP index -> topology node
    ep_nodes: tuple[int, ...]
    #: per-node memory-controller bandwidth shared by flows that source or
    #: sink at the node.  A float caps every node uniformly; a mapping
    #: (node -> bytes/s) caps per chiplet; the string ``"auto"`` asks
    #: :meth:`~repro_torch.core.platform.Platform.with_fabric` to derive the
    #: per-node caps from each EP's ``mem_bw`` at attach time (until then it
    #: behaves as disabled); ``None`` disables the hotspot model.
    mc_bw: "float | Mapping[int, float] | str | None" = None
    #: ``"static"`` — every flow takes the topology's fixed XY/Dijkstra
    #: route (pre-adaptive behaviour, bit-for-bit).  ``"adaptive"`` — flows
    #: are assigned paths by congestion-priced iterated best response.
    routing: str = "static"
    #: candidate paths per flow the adaptive router chooses among
    k_paths: int = 4
    #: bound on best-response sweeps (reproducibility: the fixed point —
    #: or the sweep bound — is reached in deterministic order)
    max_sweeps: int = 8
    #: tie-break seed: exact cost ties between candidate paths resolve by a
    #: keyed hash of (seed, flow endpoints + size, path), so distinct seeds
    #: explore distinct-but-deterministic equilibria
    seed: int = 0
    #: live link-fault state: LinkKey -> bandwidth factor (0.0 = link dead,
    #: 0 < f < 1 = degraded).  Healthy links are absent.  The dict is shared
    #: *by reference* across :meth:`restrict` copies, so a fault applied to
    #: the global fabric is instantly visible to every tenant's restricted
    #: view — exactly how a physical link failure behaves.  Empty (the
    #: default) prices bit-for-bit as before faults existed.
    link_state: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.ep_nodes = tuple(self.ep_nodes)
        for n in self.ep_nodes:
            if not (0 <= n < self.topology.n_nodes):
                raise ValueError(f"EP node {n} outside topology {self.topology.name!r}")
        if self.routing not in ("static", "adaptive"):
            raise ValueError(f"unknown routing mode {self.routing!r}")
        if isinstance(self.mc_bw, str) and self.mc_bw != "auto":
            raise ValueError(f"mc_bw must be a number, mapping, 'auto' or None, got {self.mc_bw!r}")
        if self.k_paths < 1 or self.max_sweeps < 1:
            raise ValueError("need k_paths >= 1 and max_sweeps >= 1")
        #: (fault fingerprint, derived topology) — rebuilt when state changes
        self._eff_cache: tuple[tuple, Topology] = ((), self.topology)

    @property
    def n_eps(self) -> int:
        return len(self.ep_nodes)

    def node(self, ep_idx: int) -> int:
        return self.ep_nodes[ep_idx]

    def restrict(self, kept: Sequence[int]) -> "Fabric":
        """The fabric as seen by a sub-platform holding EPs ``kept``."""
        return dataclasses.replace(
            self, ep_nodes=tuple(self.ep_nodes[i] for i in kept)
        )

    def with_link_latency(self, latency_s: float) -> "Fabric":
        """Every link latency replaced — the Fig. 9 knob on a real fabric."""
        return dataclasses.replace(
            self, topology=self.topology.with_link_latency(latency_s)
        )

    def with_routing(
        self,
        routing: str,
        *,
        k_paths: int | None = None,
        max_sweeps: int | None = None,
        seed: int | None = None,
    ) -> "Fabric":
        """Copy with the routing policy replaced (knobs keep current values)."""
        return dataclasses.replace(
            self,
            routing=routing,
            k_paths=self.k_paths if k_paths is None else k_paths,
            max_sweeps=self.max_sweeps if max_sweeps is None else max_sweeps,
            seed=self.seed if seed is None else seed,
        )

    # -- link faults ----------------------------------------------------------

    def set_link_state(self, u: int, v: int, factor: float) -> None:
        """Set link ``(u, v)``'s bandwidth factor; ``>= 1`` restores it."""
        key = (u, v) if u < v else (v, u)
        if key not in self.topology.links:
            raise KeyError(f"no such link {key} in topology {self.topology.name!r}")
        if factor < 0.0:
            raise ValueError(f"link factor must be >= 0, got {factor}")
        if factor >= 1.0:
            self.link_state.pop(key, None)
        else:
            self.link_state[key] = factor

    def fail_link(self, u: int, v: int) -> None:
        self.set_link_state(u, v, 0.0)

    def degrade_link(self, u: int, v: int, factor: float) -> None:
        if not (0.0 < factor < 1.0):
            raise ValueError(f"degrade factor must be in (0, 1), got {factor}")
        self.set_link_state(u, v, factor)

    def restore_link(self, u: int, v: int) -> None:
        self.set_link_state(u, v, 1.0)

    def fault_fingerprint(self) -> tuple:
        """Canonical view of the current link faults (``()`` when healthy).

        A pure function of the fault *state*, independent of the order the
        faults were applied in — the token drift fingerprints fold in so a
        link change is visible even when EP factors and the dead set are
        untouched.
        """
        return tuple(sorted(self.link_state.items()))

    def _topo(self) -> Topology:
        """The effective topology under the current link faults.

        Identity (``self.topology``, caches and all) while the fault state
        is empty — the degenerate contract.  Faulted states derive a fresh
        topology (dead links removed, degraded links' bandwidth scaled) and
        cache it against the fingerprint, so repeated pricing between fault
        transitions pays the rebuild once.
        """
        if not self.link_state:
            return self.topology
        fp = self.fault_fingerprint()
        cached_fp, cached = self._eff_cache
        if fp != cached_fp:
            cached = self.topology.with_degraded_links(self.link_state)
            self._eff_cache = (fp, cached)
        return cached

    def effective_topology(self) -> Topology:
        """Public view of :meth:`_topo` for pricing callers outside the package."""
        return self._topo()

    def marooned_eps(self) -> tuple[int, ...]:
        """EPs cut off from the main component by dead links.

        The *main* component is the one hosting the most EPs (ties: the one
        containing the smallest node id).  EPs bound to any other component
        cannot exchange activations with the majority of the platform, so
        placement rescues treat them like dead EPs until the link heals.
        """
        topo = self._topo()
        comps = topo.components()
        if len(comps) <= 1:
            return ()
        count = {c: sum(1 for n in self.ep_nodes if n in set(c)) for c in comps}
        main = max(comps, key=lambda c: (count[c], -c[0]))
        main_set = set(main)
        return tuple(
            ep for ep, n in enumerate(self.ep_nodes) if n not in main_set
        )

    # -- routing shortcuts ----------------------------------------------------

    def route_ep(self, src_ep: int, dst_ep: int) -> tuple[LinkKey, ...]:
        return self._topo().route(self.ep_nodes[src_ep], self.ep_nodes[dst_ep])

    def latency_ep(self, src_ep: int, dst_ep: int) -> float:
        """Routed latency between two EPs; ``inf`` when faults severed them."""
        topo = self._topo()
        src, dst = self.ep_nodes[src_ep], self.ep_nodes[dst_ep]
        if self.link_state and not topo.connected(src, dst):
            return float("inf")
        return topo.path_latency(src, dst)

    # -- contention pricing ---------------------------------------------------

    def _endpoints(self, flow: Flow) -> tuple[int, int]:
        if flow.nodes:
            return flow.src, flow.dst
        return self.ep_nodes[flow.src], self.ep_nodes[flow.dst]

    def _mc_cap(self, node: int) -> float | None:
        """Memory-controller bandwidth cap at ``node``, or None (uncapped).

        An unresolved ``"auto"`` (fabric never attached to a platform) is
        treated as disabled — there is no EP spec to derive the cap from.
        """
        if self.mc_bw is None or isinstance(self.mc_bw, str):
            return None
        if isinstance(self.mc_bw, Mapping):
            return self.mc_bw.get(node)
        return self.mc_bw

    @property
    def _mc_enabled(self) -> bool:
        return self.mc_bw is not None and not isinstance(self.mc_bw, str)

    def _loads(
        self,
        pairs: Sequence[tuple[int, int]],
        routes: Sequence[tuple[LinkKey, ...]],
    ) -> tuple[dict[LinkKey, int], dict[int, int]]:
        """(flows per link, flows per capped endpoint node) of a route set."""
        link_load: dict[LinkKey, int] = {}
        node_load: dict[int, int] = {}
        for (s, d), r in zip(pairs, routes):
            if r is None:
                continue  # severed flow: consumes no link or MC capacity
            for k in r:
                link_load[k] = link_load.get(k, 0) + 1
            if r and self._mc_enabled:
                node_load[s] = node_load.get(s, 0) + 1
                node_load[d] = node_load.get(d, 0) + 1
        return link_load, node_load

    def _price(
        self,
        flows: Sequence[Flow],
        pairs: Sequence[tuple[int, int]],
        routes: Sequence["tuple[LinkKey, ...] | None"],
    ) -> list[float]:
        """Fair-share + hotspot pricing of flows on an explicit route set.

        A ``None`` route means link faults severed the flow's endpoints:
        the transfer can never complete, so it prices ``inf`` (the serving
        layer surfaces that as a ``"link-loss"`` drift rather than an
        exception mid-simulation).
        """
        links = self._topo().links
        link_load, node_load = self._loads(pairs, routes)
        times = []
        for f, (s, d), r in zip(flows, pairs, routes):
            if r is None:
                times.append(float("inf"))
                continue
            if not r:
                times.append(0.0)
                continue
            eff = min(links[k].bw / link_load[k] for k in r)
            if self._mc_enabled:
                for node in (s, d):
                    cap = self._mc_cap(node)
                    if cap is not None:
                        eff = min(eff, cap / node_load[node])
            times.append(f.nbytes / eff + sum(links[k].latency for k in r))
        return times

    def flow_times(self, flows: Sequence[Flow]) -> list[float]:
        """Transfer time of each flow under the whole set's contention.

        Deterministic in the multiset of flows; a flow between co-located
        endpoints costs 0 (it never leaves the chiplet).  Under
        ``routing="adaptive"`` each flow is first assigned a path by
        :meth:`route_flows`; under ``"static"`` every flow takes the
        topology's fixed route, exactly as before adaptive routing existed.
        """
        pairs = [self._endpoints(f) for f in flows]
        routes = self.route_flows(flows)
        return self._price(flows, pairs, routes)

    def transfer_time(
        self,
        src_ep: int,
        dst_ep: int,
        nbytes: float,
        background: Sequence[Flow] = (),
    ) -> float:
        """Price one transfer given concurrent ``background`` flows."""
        flows = [Flow(src_ep, dst_ep, nbytes)] + list(background)
        return self.flow_times(flows)[0]

    # -- routing --------------------------------------------------------------

    def route_flows(self, flows: Sequence[Flow]) -> list[tuple[LinkKey, ...]]:
        """The per-flow link-sequence assignment the fabric prices under.

        Static mode: every flow takes the topology's fixed route — a pure
        function of (src, dst), independent of the rest of the flow set.
        Adaptive mode: iterated best response over the whole flow set (see
        :meth:`_adaptive_routes`); a pure function of (topology, flow
        multiset, seed), never worse than static in total priced cost.
        """
        pairs = [self._endpoints(f) for f in flows]
        topo = self._topo()
        static: list[tuple[LinkKey, ...] | None] = []
        for (s, d) in pairs:
            if s == d:
                static.append(())
            elif self.link_state and not topo.connected(s, d):
                static.append(None)  # severed by link faults: prices inf
            else:
                static.append(topo.route(s, d))
        if self.routing != "adaptive":
            return static
        return self._adaptive_routes(flows, pairs, static)

    def _tiebreak(
        self, endpoints: tuple[int, int], nbytes: float, route: tuple[LinkKey, ...]
    ) -> int:
        """Seeded, platform-independent tie-break between equal-cost paths.

        Keyed on the flow's *identity* (endpoints + size), not its list
        position, so the choice survives reordering of the flow set.
        """
        key = f"{self.seed}|{endpoints}|{nbytes!r}|{route}".encode()
        return int.from_bytes(hashlib.sha256(key).digest()[:8], "big")

    def _adaptive_routes(
        self,
        flows: Sequence[Flow],
        pairs: Sequence[tuple[int, int]],
        static: Sequence[tuple[LinkKey, ...]],
    ) -> list[tuple[LinkKey, ...]]:
        """Congestion-priced path assignment by iterated best response.

        Starting from the all-static assignment, flows are visited in the
        canonical order of their identity — sorted by (endpoints, nbytes),
        positions only disambiguating exact duplicates, which are mutually
        interchangeable — so the assignment is a function of the flow
        *multiset*, not of the order a caller happened to assemble the list
        in.  Each flow picks, among its candidate paths (the static route
        plus the topology's ``k_paths`` shortest loopless paths — which
        include express/shortcut links XY routing never takes), the path
        minimizing its own contention-priced transfer time given where
        every other flow currently runs.  Sweeps repeat until a fixed point
        or ``max_sweeps``, whichever first; exact cost ties resolve by
        (fewest hops, seeded hash of the flow identity and path), so the
        result is reproducible.  The
        best-response equilibrium of a congestion game need not improve the
        *sum* — so the all-static assignment is kept whenever it prices no
        worse in total, which is what makes adaptive routing safe to leave
        on: it can only ever lower the total priced cost of a flow set.
        """
        from .topology import path_links

        topo = self._topo()
        cands: list[list[tuple[LinkKey, ...]]] = []
        for (s, d), st_route in zip(pairs, static):
            if s == d or st_route is None:
                # co-located (route ()) or severed (route None): nothing for
                # best response to choose among
                cands.append([st_route])
                continue
            seen = {st_route}
            cl = [st_route]
            for path in topo.k_shortest_paths(s, d, self.k_paths):
                r = path_links(path)
                if r not in seen:
                    seen.add(r)
                    cl.append(r)
            cands.append(cl)

        assign = list(static)
        link_load: dict[LinkKey, int] = {}
        node_load: dict[int, int] = {}
        for (s, d), r in zip(pairs, assign):
            if r is None:
                continue
            for k in r:
                link_load[k] = link_load.get(k, 0) + 1
            if r and self._mc_enabled:
                node_load[s] = node_load.get(s, 0) + 1
                node_load[d] = node_load.get(d, 0) + 1

        links = topo.links
        order = sorted(
            range(len(flows)), key=lambda i: (pairs[i], flows[i].nbytes, i)
        )
        for _sweep in range(self.max_sweeps):
            changed = False
            for i in order:
                f = flows[i]
                if len(cands[i]) <= 1:
                    continue
                s, d = pairs[i]
                for k in assign[i]:  # price candidates against the others
                    link_load[k] -= 1
                # endpoint MC load is route-independent (every candidate
                # sources at s and sinks at d), so it is a constant floor
                # under the candidate comparison — but it must be in the
                # cost so "minimize its contention-priced cost" stays true
                mc_floor = None
                if self._mc_enabled:
                    for node in (s, d):
                        cap = self._mc_cap(node)
                        if cap is not None:
                            share = cap / node_load[node]
                            mc_floor = share if mc_floor is None else min(mc_floor, share)

                def priced(route: tuple[LinkKey, ...]) -> float:
                    eff = min(links[k].bw / (link_load.get(k, 0) + 1) for k in route)
                    if mc_floor is not None:
                        eff = min(eff, mc_floor)
                    return f.nbytes / eff + sum(links[k].latency for k in route)

                best = min(
                    cands[i],
                    key=lambda r: (
                        priced(r),
                        len(r),
                        self._tiebreak(pairs[i], f.nbytes, r),
                    ),
                )
                if best != assign[i]:
                    assign[i] = best
                    changed = True
                for k in assign[i]:
                    link_load[k] = link_load.get(k, 0) + 1
            if not changed:
                break

        # never-worse-than-static: a selfish equilibrium may price worse in
        # total than everyone staying on the default path; keep static then
        # (ties keep static, preserving the pre-adaptive assignment exactly)
        adaptive_total = sum(self._price(flows, pairs, assign))
        static_total = sum(self._price(flows, pairs, static))
        if adaptive_total < static_total:
            return assign
        return list(static)


# ---------------------------------------------------------------------------
# platform-derived preset
# ---------------------------------------------------------------------------


def scalar_fabric(platform) -> Fabric:
    """The degenerate fabric that reproduces the scalar-link model exactly.

    Every EP pair gets a direct link with ``bw = min`` / ``latency = max``
    of the two EPs' scalar link specs — precisely the expression
    ``core.evaluator`` used before fabrics existed, so a platform with this
    fabric attached prices every transfer bit-for-bit identically to the
    same platform without one (single-hop route, load 1, no hotspot model).
    ``platform`` is duck-typed (anything with ``.eps[i].link_bw`` /
    ``.link_latency``) to keep this package import-free of ``repro_torch.core``.

    ``mc_bw`` stays ``None`` (not ``"auto"``) and routing stays static by
    construction: the degenerate fabric's whole contract is reproducing the
    pre-fabric arithmetic exactly, and both the hotspot cap and adaptive
    path choice would add terms the scalar model never had.
    """
    eps = platform.eps
    links: dict[LinkKey, Link] = {}
    for i in range(len(eps)):
        for j in range(i + 1, len(eps)):
            links[(i, j)] = Link(
                bw=min(eps[i].link_bw, eps[j].link_bw),
                latency=max(eps[i].link_latency, eps[j].link_latency),
            )
    topo = Topology(name=f"{platform.name}-scalar", n_nodes=len(eps), links=links)
    return Fabric(topology=topo, ep_nodes=tuple(range(len(eps))))


def uniform_fabric(
    topology: Topology,
    n_eps: int | None = None,
    mc_bw: "float | Mapping[int, float] | str | None" = "auto",
    *,
    routing: str = "static",
    k_paths: int = 4,
    max_sweeps: int = 8,
    seed: int = 0,
) -> Fabric:
    """Bind EPs 0..n-1 to topology nodes 0..n-1 (the common identity case).

    ``mc_bw`` defaults to ``"auto"``: once the fabric is attached with
    :meth:`~repro_torch.core.platform.Platform.with_fabric`, every node's
    memory-controller cap is derived from its EP's ``mem_bw`` — the hotspot
    model is *on by default* for the gem5-style preset platforms (pass
    ``None`` to disable it explicitly).  Standalone fabrics (never attached)
    have no EP specs to derive from and price as uncapped.
    """
    n = n_eps if n_eps is not None else topology.n_nodes
    if n > topology.n_nodes:
        raise ValueError(f"{n} EPs need at least {n} nodes, topology has {topology.n_nodes}")
    return Fabric(
        topology=topology,
        ep_nodes=tuple(range(n)),
        mc_bw=mc_bw,
        routing=routing,
        k_paths=k_paths,
        max_sweeps=max_sweeps,
        seed=seed,
    )
