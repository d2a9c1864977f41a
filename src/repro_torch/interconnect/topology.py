"""Chiplet interconnect topology: nodes, links and deterministic routing.

The paper (Shisha §2/§6) defines heterogeneity "at the level of cores,
memory subsystem *and the interconnect*", and its Fig. 9 sensitivity study
sweeps a single inter-chiplet latency scalar.  This module upgrades that
scalar into a graph: a :class:`Topology` is a set of router nodes joined by
:class:`Link`\\ s with individual bandwidth/latency, plus a deterministic
routing function.  Presets cover the fabrics real chiplet packages use —
2D mesh (XY dimension-ordered routing), ring, crossbar (a star through a
central switch) and a hierarchical "package of chiplets" — alongside the
fully-connected degenerate that reproduces the old scalar-link model
bit-for-bit (see :func:`repro_torch.interconnect.fabric.scalar_fabric`).

Routing is a pure function of the topology: the same (src, dst) pair always
returns the identical link sequence, which is what keeps the evaluator and
every tuner built on it deterministic.  Mesh topologies use XY
dimension-ordered routing (the standard deadlock-free NoC choice); every
other topology routes by Dijkstra over (total latency, hop count, lexico-
graphically smallest node sequence), so ties can never depend on dict or
heap iteration order.

Links are heterogeneous: every preset can mix fast and slow links in one
fabric — meshes grow row *express channels* (long-range links skipping
intermediate routers, as in express-cube NoCs), crossbars take per-port
uplink bandwidths (a slow port models a chiplet hanging off a previous-gen
PHY), rings take per-segment bandwidths, and the hierarchical preset keeps
its intra-/inter-package asymmetry.  Static XY/Dijkstra routing ignores
bandwidth entirely (it is latency/hop-ordered), so heterogeneous bandwidths
only matter to the contention pricing — and to the *adaptive* router
(:class:`~repro_torch.interconnect.fabric.Fabric` with ``routing="adaptive"``),
which chooses among :meth:`Topology.k_shortest_paths` by congested cost.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Mapping, Sequence

#: normalized undirected link key: (u, v) with u < v
LinkKey = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Link:
    """One physical inter-router link."""

    #: bandwidth, bytes/s
    bw: float
    #: one-way traversal latency, seconds (per-hop share of the Fig. 9 knob)
    latency: float

    def __post_init__(self):
        if self.bw <= 0 or self.latency < 0:
            raise ValueError(f"bad link spec bw={self.bw} latency={self.latency}")


def _key(u: int, v: int) -> LinkKey:
    if u == v:
        raise ValueError(f"self-link at node {u}")
    return (u, v) if u < v else (v, u)


def path_links(path: Sequence[int]) -> tuple[LinkKey, ...]:
    """The normalized link sequence of a node path (adjacent hops)."""
    return tuple(_key(a, b) for a, b in zip(path, path[1:]))


@dataclasses.dataclass(eq=False)
class Topology:
    """An undirected interconnect graph with per-link bandwidth/latency.

    ``coords`` (optional) places nodes on a 2D grid and switches routing to
    XY dimension-ordered; without coordinates routes come from deterministic
    Dijkstra.  Instances compare by identity — two separately built
    topologies are distinct objects even if structurally equal, which keeps
    them safely usable inside frozen :class:`~repro_torch.core.platform.Platform`
    dataclasses (the ``fabric`` field is excluded from comparison).
    """

    name: str
    n_nodes: int
    links: Mapping[LinkKey, Link]
    #: node -> (x, y) grid position; enables XY routing on meshes
    coords: Mapping[int, tuple[int, int]] | None = None

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError("topology needs at least one node")
        self.links = {_key(*k): l for k, l in self.links.items()}
        adj: dict[int, list[int]] = {n: [] for n in range(self.n_nodes)}
        for (u, v) in self.links:
            if not (0 <= u < self.n_nodes and 0 <= v < self.n_nodes):
                raise ValueError(f"link ({u},{v}) outside 0..{self.n_nodes - 1}")
            adj[u].append(v)
            adj[v].append(u)
        #: node -> sorted neighbour list (sorted: no dict-order dependence)
        self._adj = {n: tuple(sorted(ns)) for n, ns in adj.items()}
        self._routes: dict[tuple[int, int], tuple[LinkKey, ...]] = {}
        self._kpaths: dict[tuple[int, int, int], tuple[tuple[int, ...], ...]] = {}

    def link(self, u: int, v: int) -> Link:
        return self.links[_key(u, v)]

    def neighbors(self, node: int) -> tuple[int, ...]:
        return self._adj[node]

    # -- routing ------------------------------------------------------------

    def route(self, src: int, dst: int) -> tuple[LinkKey, ...]:
        """Deterministic link sequence from ``src`` to ``dst``.

        XY dimension-ordered on grids with coordinates (when every grid hop
        exists), shortest-path otherwise.  Cached: repeated queries are O(1)
        and — by construction — identical.
        """
        if src == dst:
            return ()
        key = (src, dst)
        if key not in self._routes:
            path = None
            if self.coords is not None:
                path = self._xy_path(src, dst)
            if path is None:
                path = self._dijkstra_path(src, dst)
            self._routes[key] = tuple(
                _key(a, b) for a, b in zip(path, path[1:])
            )
        return self._routes[key]

    def path_latency(self, src: int, dst: int) -> float:
        """Total routed latency (sum of per-hop link latencies)."""
        return sum(self.links[k].latency for k in self.route(src, dst))

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst))

    def _xy_path(self, src: int, dst: int) -> list[int] | None:
        """X-then-Y dimension-ordered walk; None if a grid hop is missing."""
        by_pos = {pos: n for n, pos in self.coords.items()}
        x, y = self.coords[src]
        dx, dy = self.coords[dst]
        path = [src]
        while x != dx:
            x += 1 if dx > x else -1
            nxt = by_pos.get((x, y))
            if nxt is None or _key(path[-1], nxt) not in self.links:
                return None
            path.append(nxt)
        while y != dy:
            y += 1 if dy > y else -1
            nxt = by_pos.get((x, y))
            if nxt is None or _key(path[-1], nxt) not in self.links:
                return None
            path.append(nxt)
        return path

    def _dijkstra_path(self, src: int, dst: int) -> list[int]:
        """Min (latency, hops, lexicographic node sequence) path."""
        found = self._constrained_path(src, dst, frozenset(), frozenset())
        if found is None:
            raise ValueError(f"no route {src} -> {dst} in topology {self.name!r}")
        return list(found)

    def _constrained_path(
        self,
        src: int,
        dst: int,
        banned_edges: frozenset[LinkKey],
        banned_nodes: frozenset[int],
    ) -> tuple[int, ...] | None:
        """Deterministic Dijkstra avoiding the given edges/nodes (Yen spur).

        Heap entries are fully ordered (latency, hops, path) tuples, so pop
        order — and thereby the chosen path — is independent of insertion
        order.
        """
        heap: list[tuple[float, int, tuple[int, ...]]] = [(0.0, 0, (src,))]
        done: set[int] = set()
        while heap:
            lat, hops, path = heapq.heappop(heap)
            node = path[-1]
            if node == dst:
                return path
            if node in done:
                continue
            done.add(node)
            for nxt in self._adj[node]:
                if nxt in done or nxt in banned_nodes:
                    continue
                k = _key(node, nxt)
                if k in banned_edges:
                    continue
                l = self.links[k]
                heapq.heappush(heap, (lat + l.latency, hops + 1, path + (nxt,)))
        return None

    def _path_cost(self, path: Sequence[int]) -> tuple[float, int, tuple[int, ...]]:
        lat = sum(self.links[_key(a, b)].latency for a, b in zip(path, path[1:]))
        return (lat, len(path) - 1, tuple(path))

    def k_shortest_paths(self, src: int, dst: int, k: int) -> tuple[tuple[int, ...], ...]:
        """Up to ``k`` loopless paths ``src`` -> ``dst``, cheapest first.

        Yen's algorithm over the same deterministic (latency, hops,
        lexicographic node sequence) order as :meth:`route`'s Dijkstra, so
        the enumeration is a pure function of the topology: identical
        topologies yield identical path lists in identical order — the
        foundation of the adaptive router's determinism contract.  Paths
        include express/shortcut links XY routing never takes.  Cached.
        """
        if src == dst:
            return ((src,),)
        if k < 1:
            raise ValueError(f"need k >= 1 paths, got {k}")
        key = (src, dst, k)
        if key not in self._kpaths:
            first = self._constrained_path(src, dst, frozenset(), frozenset())
            if first is None:
                raise ValueError(f"no route {src} -> {dst} in topology {self.name!r}")
            paths: list[tuple[int, ...]] = [first]
            # candidate heap of (cost, path); costs are fully ordered tuples
            cands: list[tuple[tuple[float, int, tuple[int, ...]], tuple[int, ...]]] = []
            seen = {first}
            while len(paths) < k:
                prev = paths[-1]
                for i in range(len(prev) - 1):
                    spur, root = prev[i], prev[: i + 1]
                    banned_edges = frozenset(
                        _key(p[i], p[i + 1])
                        for p in paths
                        if len(p) > i + 1 and p[: i + 1] == root
                    )
                    banned_nodes = frozenset(root[:-1])
                    tail = self._constrained_path(spur, dst, banned_edges, banned_nodes)
                    if tail is None:
                        continue
                    cand = root[:-1] + tail
                    if cand not in seen:
                        seen.add(cand)
                        heapq.heappush(cands, (self._path_cost(cand), cand))
                if not cands:
                    break
                paths.append(heapq.heappop(cands)[1])
            self._kpaths[key] = tuple(paths)
        return self._kpaths[key]

    # -- derived topologies ---------------------------------------------------

    def with_link_latency(self, latency_s: float) -> "Topology":
        """Copy with every link's latency replaced (the Fig. 9 sweep knob)."""
        return Topology(
            name=f"{self.name}@lat{latency_s:g}",
            n_nodes=self.n_nodes,
            links={k: dataclasses.replace(l, latency=latency_s) for k, l in self.links.items()},
            coords=self.coords,
        )

    def with_scaled_bw(self, factor: float) -> "Topology":
        """Copy with every link's bandwidth multiplied by ``factor``.

        Preserves heterogeneity (a 2x-faster fabric is still the same mix of
        fast and slow links); the metamorphic contract is that scaling every
        bandwidth up can never *increase* any contention-priced transfer.
        """
        if factor <= 0:
            raise ValueError(f"bandwidth scale factor must be positive, got {factor}")
        return Topology(
            name=f"{self.name}@bwx{factor:g}",
            n_nodes=self.n_nodes,
            links={k: dataclasses.replace(l, bw=l.bw * factor) for k, l in self.links.items()},
            coords=self.coords,
        )

    def without_link(self, *keys: LinkKey) -> "Topology":
        """Copy with the given links removed — a hard link failure.

        The derived instance rebuilds its adjacency and route/k-path caches
        from scratch, so dead links vanish from :meth:`route` *and* from
        every :meth:`k_shortest_paths` candidate list.  Removal may
        disconnect the graph: routes between severed components then raise,
        and :meth:`connected` / :meth:`components` let callers detect the
        partition instead of tripping over it.
        """
        dead = {_key(*k) for k in keys}
        missing = sorted(dead - set(self.links))
        if missing:
            raise KeyError(f"no such links {missing} in topology {self.name!r}")
        return Topology(
            name=f"{self.name}-{len(dead)}link",
            n_nodes=self.n_nodes,
            links={k: l for k, l in self.links.items() if k not in dead},
            coords=self.coords,
        )

    def with_degraded_links(self, factors: Mapping[LinkKey, float]) -> "Topology":
        """Copy with per-link bandwidth multipliers; factor 0 removes a link.

        The chaos layer's combined view of a faulted fabric: hard-failed
        links (factor 0) disappear from routing entirely, degraded links
        (0 < factor < 1) keep routing but price at the reduced bandwidth.
        """
        state = {_key(*k): f for k, f in factors.items()}
        missing = sorted(set(state) - set(self.links))
        if missing:
            raise KeyError(f"no such links {missing} in topology {self.name!r}")
        for k in sorted(state):
            if not (0.0 <= state[k] <= 1.0):
                raise ValueError(f"link factor must be in [0, 1], got {state[k]} for {k}")
        links: dict[LinkKey, Link] = {}
        for k, l in self.links.items():
            f = state.get(k, 1.0)
            if f <= 0.0:
                continue
            links[k] = l if f >= 1.0 else dataclasses.replace(l, bw=l.bw * f)
        return Topology(
            name=f"{self.name}!faults{len(state)}",
            n_nodes=self.n_nodes,
            links=links,
            coords=self.coords,
        )

    # -- connectivity ---------------------------------------------------------

    def components(self) -> tuple[tuple[int, ...], ...]:
        """Connected components as sorted node tuples, ordered by least node."""
        seen: set[int] = set()
        comps: list[tuple[int, ...]] = []
        for start in range(self.n_nodes):
            if start in seen:
                continue
            comp = [start]
            seen.add(start)
            frontier = [start]
            while frontier:
                node = frontier.pop()
                for nxt in self._adj[node]:
                    if nxt not in seen:
                        seen.add(nxt)
                        comp.append(nxt)
                        frontier.append(nxt)
            comps.append(tuple(sorted(comp)))
        return tuple(comps)

    def connected(self, src: int, dst: int) -> bool:
        """Is there any path ``src`` -> ``dst``?  (Cheap; no route built.)"""
        if src == dst:
            return True
        return self._constrained_path(src, dst, frozenset(), frozenset()) is not None


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


def fully_connected(
    n: int, bw: float = 25e9, latency: float = 100e-9, name: str = "full"
) -> Topology:
    """Every node pair joined directly — the degenerate scalar-link fabric."""
    links = {(i, j): Link(bw, latency) for i in range(n) for j in range(i + 1, n)}
    return Topology(name=name, n_nodes=n, links=links)


def mesh2d(
    rows: int,
    cols: int,
    bw: float = 25e9,
    latency: float = 100e-9,
    *,
    express_bw: float | None = None,
    express_latency: float | None = None,
    express_stride: int = 2,
) -> Topology:
    """``rows x cols`` 2D mesh with XY routing (node = r * cols + c).

    ``express_bw`` adds *express channels* along every row: extra links
    joining nodes ``express_stride`` columns apart (express-cube NoC style),
    with their own bandwidth/latency — per-link heterogeneity inside one
    mesh.  XY dimension-ordered routing walks unit grid steps only, so the
    static route never uses an express link and stays bit-for-bit what it
    was without them; only the adaptive router (and explicit
    :meth:`Topology.k_shortest_paths` callers) can exploit them.
    """
    links: dict[LinkKey, Link] = {}
    coords: dict[int, tuple[int, int]] = {}
    for r in range(rows):
        for c in range(cols):
            n = r * cols + c
            coords[n] = (c, r)
            if c + 1 < cols:
                links[(n, n + 1)] = Link(bw, latency)
            if r + 1 < rows:
                links[(n, n + cols)] = Link(bw, latency)
    name = f"mesh{rows}x{cols}"
    if express_bw is not None:
        if express_stride < 2:
            raise ValueError(f"express stride must be >= 2, got {express_stride}")
        e_lat = express_latency if express_latency is not None else latency
        for r in range(rows):
            for c in range(cols - express_stride):
                n = r * cols + c
                links[(n, n + express_stride)] = Link(express_bw, e_lat)
        name += f"+x{express_stride}"
    return Topology(name=name, n_nodes=rows * cols, links=links, coords=coords)


def ring(
    n: int,
    bw: float = 25e9,
    latency: float = 100e-9,
    *,
    segment_bws: Sequence[float] | None = None,
) -> Topology:
    """Bidirectional ring; routes take the shorter arc (ties: smaller ids).

    ``segment_bws[i]`` overrides the bandwidth of the segment joining node
    ``i`` to node ``(i + 1) % n`` — a ring with one slow segment is the
    smallest fabric where congestion-aware routing pays (the long arc around
    the slow segment can be the cheaper one under load).
    """
    if segment_bws is not None:
        if n < 3:
            raise ValueError(
                f"a {n}-node ring collapses to a single link; "
                "per-segment bandwidths are ambiguous there"
            )
        if len(segment_bws) != n:
            raise ValueError(f"need {n} segment bandwidths, got {len(segment_bws)}")
    links = {
        _key(i, (i + 1) % n): Link(segment_bws[i] if segment_bws is not None else bw, latency)
        for i in range(n)
    }
    return Topology(name=f"ring{n}", n_nodes=n, links=links)


def crossbar(
    n: int,
    bw: float = 25e9,
    latency: float = 100e-9,
    *,
    port_bws: Sequence[float] | None = None,
) -> Topology:
    """A central switch: n ports star-wired to hub node ``n``.

    Every port-to-port route is two hops through the hub (each hub link
    carries half the end-to-end latency), and port links are the contention
    points — concurrent flows into one port fair-share its link, which is
    how a real crossbar's output-port conflicts behave.  ``port_bws[i]``
    overrides port ``i``'s uplink bandwidth: a slow uplink models a chiplet
    hanging off a previous-generation PHY, the heterogeneity §2 of the paper
    puts in the interconnect itself.
    """
    if port_bws is not None and len(port_bws) != n:
        raise ValueError(f"need {n} port bandwidths, got {len(port_bws)}")
    links = {
        (i, n): Link(port_bws[i] if port_bws is not None else bw, latency / 2.0)
        for i in range(n)
    }
    return Topology(name=f"xbar{n}", n_nodes=n + 1, links=links)


def hierarchical(
    n_packages: int,
    chiplets_per_package: int,
    intra_bw: float = 50e9,
    intra_latency: float = 50e-9,
    inter_bw: float = 12.5e9,
    inter_latency: float = 500e-9,
) -> Topology:
    """Packages of chiplets: dense fast links inside a package, one slow
    gateway link between each package pair (chiplet 0 is the gateway)."""
    links: dict[LinkKey, Link] = {}
    cpp = chiplets_per_package
    for p in range(n_packages):
        base = p * cpp
        for i in range(cpp):
            for j in range(i + 1, cpp):
                links[(base + i, base + j)] = Link(intra_bw, intra_latency)
    for p in range(n_packages):
        for q in range(p + 1, n_packages):
            links[(p * cpp, q * cpp)] = Link(inter_bw, inter_latency)
    return Topology(
        name=f"hier{n_packages}x{cpp}",
        n_nodes=n_packages * cpp,
        links=links,
    )
