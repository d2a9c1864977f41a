"""Power/thermal tour on the port: DVFS ladders, a package power cap, and
tuning under it.

    PYTHONPATH=src python examples/power_tour_torch.py

The twin of ``examples/power_tour.py`` over ``repro_torch.core`` and
``repro_torch.power``, stops 1-4, printing the same lines.  Stops 5-6 (serving
with the thermal RC model live, and thermal throttling as drift answered by
a DVFS step) need the serving layer (``serve/``), which the port does not
have yet.

Stops on the tour:
1. Attaches a package power model to the paper's 4-EP big/LITTLE platform
   and prints one FEP's DVFS ladder — the cubic dynamic-power law makes a
   20% clock cut roughly halve the dynamic watts.
2. Shows the degenerate model (one nominal level, no cap) reproducing the
   power-free schedule bit-for-bit — the fabric playbook's regression pin.
3. Down-clocks one EP and prices the trade directly: slower stage times,
   fewer watts.
4. Tunes under a binding package cap with ``tune(dvfs=True)``: the loop
   steps in-use EPs down until the cap admits them, then keeps exploring
   boundary moves and frequency knobs together.
"""

from repro_torch.core import DatabaseEvaluator, Trace, paper_platform, weights
from repro_torch.core.heuristics import run_shisha
from repro_torch.core.tuner import tune
from repro_torch.models.cnn import network_layers
from repro_torch.power import degenerate_power, uniform_power

layers = network_layers("synthnet")
ws = weights(layers)
plat = paper_platform(4)

# -- 1. the package model and one EP's DVFS ladder ---------------------------

pm = uniform_power(plat)
print("[power] FEP0 DVFS ladder (cubic dynamic law, mild leakage slope):")
for i, lvl in enumerate(pm.specs[0].levels):
    print(
        f"[power]   {lvl.name}: scale {lvl.scale:.2f} -> "
        f"{lvl.dynamic_w:5.2f} W dynamic + {lvl.static_w:.2f} W static"
    )
conf = run_shisha(ws, Trace(DatabaseEvaluator(plat, layers)), "H3").result.best_conf
print(
    f"[power] nominal package draw with {conf.pretty()} all-busy: "
    f"{pm.package_w(conf.eps):.1f} W ({pm.static_package_w:.1f} W of it leakage)"
)

# -- 2. the degenerate model is the power-free platform ----------------------

plain = DatabaseEvaluator(plat, layers).stage_times(conf)
degen = DatabaseEvaluator(
    plat.with_power(degenerate_power(plat)), layers
).stage_times(conf)
print(f"[degen] degenerate power model == power-free evaluator, bit-for-bit: {plain == degen}")

# -- 3. one EP down a level: the speed/watts trade priced --------------------

pm_slow = uniform_power(plat)
pm_slow.set_level(conf.eps[0], 2)
slow = DatabaseEvaluator(plat.with_power(pm_slow), layers).stage_times(conf)
print(
    f"[dvfs ] EP{conf.eps[0]} at L2 (scale {pm_slow.scale(conf.eps[0]):.2f}): "
    f"stage 0 {plain[0] * 1e3:.2f}ms -> {slow[0] * 1e3:.2f}ms, "
    f"dynamic {pm.dynamic_w(conf.eps[0]):.1f} W -> {pm_slow.dynamic_w(conf.eps[0]):.1f} W"
)

# -- 4. tuning under a binding package cap -----------------------------------

cap_w = 0.7 * pm.package_w(conf.eps)
pm_cap = uniform_power(plat, cap_w=cap_w)
trace = Trace(DatabaseEvaluator(plat.with_power(pm_cap), layers))
capped = tune(conf, trace, dvfs=True)
print(
    f"[cap  ] {cap_w:.1f} W cap (binding at nominal): tune(dvfs=True) adopts "
    f"levels {list(capped.dvfs_levels)} -> {pm_cap.package_w(capped.best_conf.eps):.1f} W, "
    f"throughput {capped.best_throughput:.2f}/s over {trace.n_trials} paid trials"
)
