"""``repro_torch.interconnect`` — the chiplet fabric as a first-class subsystem.

The port's copy of the JAX package's ``interconnect`` (standard library
only, no import of the JAX package).

Shisha's premise is heterogeneity "at the level of cores, memory subsystem
and the interconnect" (§2); the pre-fabric evaluator collapsed the third
axis to one scalar link (the Fig. 9 latency knob).  This package models the
interconnect as a graph instead:

  * :mod:`.topology` — router nodes + per-link bandwidth/latency, preset
    fabrics (2D mesh with optional row express channels, ring with
    per-segment bandwidths, crossbar with per-port uplink bandwidths,
    hierarchical package-of-chiplets with intra-/inter-package asymmetry,
    fully-connected) with heterogeneous links, deterministic routing (XY on
    meshes, tie-broken Dijkstra elsewhere) and deterministic k-shortest-path
    enumeration (Yen's algorithm).
  * :mod:`.fabric`   — the EP -> node binding plus contention pricing:
    fair-share slowdown on shared links and memory-controller hotspots
    (per-node caps derived from EP ``mem_bw`` by default at attach time),
    evaluated over the steady-state flow set of a pipelined schedule — and
    the routing *decision* itself: ``routing="adaptive"`` assigns each flow
    a path among its k shortest candidates by congestion-priced iterated
    best response.

Attach a fabric with ``Platform.with_fabric`` and every consumer — the
evaluators, Algorithm 2 (including its placement-aware moves, each
relocation trial charged its routed hop-priced weight-shipping cost) —
prices transfers over routed, contended paths (the measured oracle,
``pipeline.runtime.MeasuringEvaluator``, keeps the scalar link for its
stage times, as the reference's does); leave it off (or use
:func:`~.fabric.scalar_fabric`) and all pre-fabric results reproduce
bit-for-bit.

**Determinism contract of the seeded fixed-point router.**  The adaptive
assignment is a *pure function* of (topology, flow multiset, ``seed``):

  1. candidate paths come from :meth:`.Topology.k_shortest_paths`, whose
     Yen enumeration orders by (total latency, hop count, lexicographically
     smallest node sequence) — no dict/heap iteration-order dependence;
  2. best-response sweeps visit flows in the canonical order of their
     identity (sorted by endpoints then size; exact duplicates are
     interchangeable), starting from the all-static assignment, for at most
     ``max_sweeps`` rounds or until a fixed point — so reordering a flow
     list never changes the assignment;
  3. exact-cost ties between candidate paths resolve by (fewest hops, then
     a SHA-256 hash keyed on (``seed``, flow endpoints + size, path)) —
     stable across processes and platforms, unlike Python's salted
     ``hash``;
  4. the final assignment is kept only if it prices strictly better *in
     total* than all-static; ties return the static assignment itself.

Consequences: repeated calls, freshly rebuilt identical topologies, and
replayed serving scenarios all see identical routes and prices (pinned by
``tests/test_fabric_properties.py`` and ``tests/test_torch_interconnect.py``), and an adaptive fabric can never
price a flow set worse than the static one it replaces.
"""

from .fabric import Fabric, Flow, scalar_fabric, uniform_fabric
from .topology import (
    Link,
    LinkKey,
    Topology,
    crossbar,
    fully_connected,
    hierarchical,
    mesh2d,
    path_links,
    ring,
)

__all__ = [
    "Fabric",
    "Flow",
    "Link",
    "LinkKey",
    "Topology",
    "crossbar",
    "fully_connected",
    "hierarchical",
    "mesh2d",
    "path_links",
    "ring",
    "scalar_fabric",
    "uniform_fabric",
]
