"""Interconnect-fabric tour on the port: from the scalar Fig. 9 knob to a
routed, contention-priced chiplet fabric.

    PYTHONPATH=src python examples/fabric_tour_torch.py

The twin of ``examples/fabric_tour.py`` over ``repro_torch.core`` and
``repro_torch.interconnect``: it prints the same lines.

Stops on the tour:
1. Builds a 2x4 mesh fabric over the paper's 8-EP big/LITTLE platform and
   prints a few XY routes (hops x per-link latency = the routed form of the
   Fig. 9 inter-chiplet-latency knob).
2. Shows the degenerate fully-connected fabric reproducing the scalar-link
   evaluator exactly (same stage times, same tuned schedule).
3. Prices one activation transfer alone vs. under a co-tenant flow on the
   same link (fair-share slowdown) and vs. a memory-controller hotspot.
4. Re-runs the Fig. 9 latency sweep on the mesh: the same knob, but now a
   3-hop transfer pays 3x the per-link latency.
5. Tunes contention-blind vs. contention-aware (live co-tenant flow set in
   the model + placement moves) and scores both under the congested ground
   truth (the Fig. 9-style experiment of the JAX package's benchmarks).
6. Flips the same fabric to routing="adaptive": the identical schedule's
   boundary transfers detour around the hammered row, strictly lowering the
   beat — and an express channel (a heterogeneous link XY routing cannot
   use) widens the gap.  Also prices a placement trial at its routed
   hop-priced weight-shipping cost.
"""

from repro_torch.core import DatabaseEvaluator, Trace, paper_platform, weights
from repro_torch.core.heuristics import run_shisha
from repro_torch.core.tuner import tune
from repro_torch.interconnect import Flow, mesh2d, scalar_fabric, uniform_fabric
from repro_torch.models.cnn import network_layers

layers = network_layers("synthnet")
ws = weights(layers)
base = paper_platform(8)

# -- 1. a mesh fabric and its routes ----------------------------------------

mesh = uniform_fabric(mesh2d(2, 4, bw=1e8, latency=1e-6))
plat = base.with_fabric(mesh)
print("[topo ] 2x4 mesh, FEP0..3 on row 0, SEP0..3 on row 1")
for src, dst in ((0, 1), (0, 7), (3, 4)):
    route = mesh.route_ep(src, dst)
    print(
        f"[route] EP{src} -> EP{dst}: {len(route)} hops via {route}, "
        f"routed latency {mesh.latency_ep(src, dst) * 1e6:.1f}us"
    )

# -- 2. the degenerate fabric is the old scalar model -----------------------

flat = base.with_fabric(scalar_fabric(base))
conf = run_shisha(ws, Trace(DatabaseEvaluator(base, layers)), "H3").result.best_conf
same = DatabaseEvaluator(base, layers).stage_times(conf) == DatabaseEvaluator(
    flat, layers
).stage_times(conf)
print(f"[degen] fully-connected fabric == scalar evaluator, bit-for-bit: {same}")

# -- 3. contention pricing ---------------------------------------------------

nbytes = 2e6
solo = mesh.transfer_time(0, 1, nbytes)
shared = mesh.transfer_time(0, 1, nbytes, background=[Flow(0, 1, nbytes, nodes=True)])
print(f"[price] {nbytes / 1e6:.0f}MB EP0->EP1 alone: {solo * 1e3:.1f}ms")
print(f"[price] same transfer next to a co-tenant flow: {shared * 1e3:.1f}ms (fair share)")
hot = uniform_fabric(mesh2d(2, 4, bw=1e8, latency=1e-6), mc_bw=5e7)
fan_in = hot.flow_times([Flow(1, 0, nbytes), Flow(4, 0, nbytes)])
print(f"[price] two flows fanning into EP0's memory controller: {fan_in[0] * 1e3:.1f}ms each")

# -- 4. the Fig. 9 knob, routed ----------------------------------------------

for lat in (1e-6, 1e-4, 1e-3):
    swept = plat.with_latency(lat)
    tp = DatabaseEvaluator(swept, layers).throughput(conf)
    print(
        f"[fig9 ] per-link latency {lat:7.0e}s -> EP0..EP7 route pays "
        f"{swept.fabric.latency_ep(0, 7) * 1e3:7.3f}ms, throughput {tp:.3f}/s"
    )

# -- 5. contention-blind vs contention-aware tuning --------------------------

congestor_pairs = ((0, 1), (1, 2), (2, 3), (0, 3))
congestor = tuple(Flow(src=s, dst=d, nbytes=2e6, nodes=True) for s, d in congestor_pairs)
blind = run_shisha(ws, Trace(DatabaseEvaluator(plat, layers)), "H3", placement=True).result.best_conf
aware_ev = DatabaseEvaluator(plat, layers)
aware_ev.background_flows = congestor
aware = tune(blind, Trace(aware_ev), placement=True).best_conf
gt = DatabaseEvaluator(plat, layers)
gt.background_flows = congestor
print(f"[tune ] co-tenant hammers the FEP-row links {list(congestor_pairs)}")
print(f"[tune ] contention-blind: {blind.pretty()} -> {gt.throughput(blind):.3f}/s under congestion")
print(f"[tune ] contention-aware: {aware.pretty()} -> {gt.throughput(aware):.3f}/s under congestion")

# -- 6. adaptive congestion-aware routing ------------------------------------

from repro_torch.core.tuner import placement_reconfig_cost
from repro_torch.interconnect import mesh2d as _mesh2d

adaptive_plat = base.with_fabric(mesh.with_routing("adaptive"))
ev_a = DatabaseEvaluator(adaptive_plat, layers)
ev_a.background_flows = congestor
beat_static, beat_adaptive = max(gt.stage_times(blind)), max(ev_a.stage_times(blind))
print(
    f"[route] same schedule, same flows: static beat {beat_static * 1e3:.1f}ms "
    f"-> adaptive beat {beat_adaptive * 1e3:.1f}ms (flows detour via row 1)"
)
express = base.with_fabric(
    uniform_fabric(
        _mesh2d(2, 4, bw=1e8, latency=1e-6, express_bw=2e8), routing="adaptive"
    )
)
ev_x = DatabaseEvaluator(express, layers)
ev_x.background_flows = congestor
print(
    f"[route] + row express channels (2x bw, invisible to XY): "
    f"adaptive beat {max(ev_x.stage_times(blind)) * 1e3:.1f}ms"
)
trace = Trace(DatabaseEvaluator(plat, layers))
far_ep = max(range(8), key=lambda e: len(mesh.route_ep(blind.eps[0], e)))
print(
    f"[price] relocating stage 0 ({blind.stages[0]} layers) to EP{far_ep} "
    f"({len(mesh.route_ep(blind.eps[0], far_ep))} hops) costs the trial "
    f"{placement_reconfig_cost(trace, blind, 0, far_ep) * 1e3:.1f}ms vs the flat "
    f"{trace.reconfig_overhead * 1e3:.1f}ms — distant chiplets are expensive to even try"
)
