"""Serving-under-traffic demo on the port: continuous Shisha rides out
faults.

    PYTHONPATH=src python examples/serve_traffic_torch.py

The twin of ``examples/serve_traffic.py`` over ``repro_torch.core``,
``repro_torch.serve`` and ``repro_torch.telemetry``, all three acts,
printing the same lines.

Act 1 — single tenant, straggler:
1. Tunes SynthNet onto the paper's 8-EP big/LITTLE platform (Alg. 1 + 2).
2. Serves bursty (MMPP) traffic through the discrete-event simulator.
3. Injects a 3x slowdown on the bottleneck EP mid-run; the continuous
   autotuner detects the drift, re-runs Algorithm 2 against the derated
   platform model (paying the exploration time on the simulated clock),
   and installs the recovered schedule.
4. Prints the load timeline so you can watch the queue build and drain.

Act 2 — two tenants on one shared clock, EP dropout:
5. Co-serves SynthNet + ResNet50 on disjoint partitions of the same
   platform and kills one of SynthNet's fast EPs mid-run.  The elastic
   partitioner prices every donor EP in requests/second of at-risk
   demand and lets SynthNet steal the cheapest one; both affected
   tenants re-tune, paying the full exploration wall-clock.

Act 3 — the same run, through the telemetry lens:
6. Act 2 ran with a live `Telemetry` session, so every request span,
   re-tune, fabric flow window, and repartition landed in one timeline.
   Exports it as Chrome trace-event JSON (open in Perfetto or
   chrome://tracing — tenants are processes; EPs, the tuner, and the
   request stream are tracks) and pretty-prints the densest tracks plus
   the cross-layer metrics registry.
"""

from repro_torch.core import DatabaseEvaluator, Trace, paper_platform, weights
from repro_torch.core.heuristics import run_shisha
from repro_torch.models.cnn import network_layers
from repro_torch.serve import (
    ContinuousShisha,
    MMPPTraffic,
    PoissonTraffic,
    ServingSimulator,
    Tenant,
    co_serve,
)
from repro_torch.telemetry import Telemetry

HORIZON = 300.0
FAULT_T = 60.0

layers = network_layers("synthnet")
plat = paper_platform(8)
ev = DatabaseEvaluator(plat, layers)

sh = run_shisha(weights(layers), Trace(ev), "H3")
conf, cap = sh.result.best_conf, sh.result.best_throughput
print(f"[tune ] {conf.pretty([ep.name for ep in plat.eps])}")
print(f"[tune ] model capacity {cap:.2f} req/s")

traffic = MMPPTraffic(rate_low=0.3 * cap, rate_high=0.8 * cap, seed=7)
tuner = ContinuousShisha(plat, layers, make_evaluator=lambda p: DatabaseEvaluator(p, layers))
sim = ServingSimulator(ev, conf, slo=3.0 * sum(ev.stage_times(conf)), autotuner=tuner)
sim.schedule_slowdown(FAULT_T, conf.eps[max(range(conf.depth), key=ev.stage_times(conf).__getitem__)], 3.0)

res = sim.run(traffic.arrivals(HORIZON), HORIZON)

print(f"[serve] {res.summary()}")
for r in res.reconfigs:
    print(
        f"[retune] t={r['t']:.1f}s kind={r['kind']} explored for "
        f"{r['tuning_cost_s']:.1f}s (simulated), new depth {r['new_depth']}, "
        f"model throughput {r['model_throughput']:.2f}/s"
    )

# crude load timeline: one row per ~10 s, bar = requests in system
if res.load_samples:
    peak = max(n for _, n in res.load_samples) or 1
    step = max(1, len(res.load_samples) // 30)
    print("[load ] t(s)  requests in system")
    for t, n in res.load_samples[::step]:
        marks = "#" * max(1, round(40 * n / peak)) if n else ""
        print(f"[load ] {t:6.1f} {marks} {n}")

# --- Act 2: elastic multi-tenancy under an EP dropout ----------------------

print()
print("[multi] co-serving synthnet + resnet50 on one shared clock")
r50 = network_layers("resnet50")
tenants = [
    Tenant(
        name="synthnet",
        layers=tuple(layers),
        traffic=PoissonTraffic(rate=0.25 * cap, seed=21),
        slo=2.7,
    ),
    Tenant(
        name="resnet50",
        layers=tuple(r50),
        traffic=MMPPTraffic(rate_low=0.5, rate_high=2.0, seed=22),
        slo=0.8,
    ),
]
tl = Telemetry()
out = co_serve(
    plat,
    tenants,
    horizon=HORIZON,
    elastic=True,
    batch_policy_search=True,
    measure_batches=2,
    alpha=4,
    faults=[("dropout", FAULT_T, 0)],  # kill global FEP0 mid-run
    telemetry=tl,
)
for r in out.results:
    print(f"[multi] {r.tenant.name:9s} eps={list(r.ep_idxs)} {r.sim.summary()}")
for e in out.repartitions:
    costs = ", ".join(f"{k}={v:.1f}s" for k, v in e.retune_costs.items())
    if e.kind == "revival":
        deal = f"EP{e.stolen_ep} revived and was granted to {e.victim}"
    elif e.stolen_ep is None:
        deal = f"EP{e.dead_ep} died; no donor could spare an EP for {e.victim}"
    else:
        price = "unpriced" if e.price is None else f"price {e.price:.2f} req/s at risk"
        deal = f"EP{e.dead_ep} died; {e.victim} stole EP{e.stolen_ep} from {e.donor} ({price})"
    print(f"[elast] t={e.t:.1f}s {deal}; re-tune costs {costs}")

# --- Act 3: the same run, through the telemetry lens -----------------------

print()
print("[trace] act 2 ran under a live Telemetry session; exporting it")
trace_path = "experiments/telemetry/serve_traffic_trace.json"
chrome = tl.export_chrome_trace(trace_path)
spans = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
instants = [e for e in chrome["traceEvents"] if e.get("ph") == "i"]
print(
    f"[trace] {len(spans)} spans + {len(instants)} instants -> {trace_path}"
    " (open in Perfetto / chrome://tracing)"
)

# densest tracks: which (process, track) pairs carry the timeline
names = {
    (e["args"]["name"], e["pid"]): None
    for e in chrome["traceEvents"]
    if e.get("ph") == "M" and e["name"] == "process_name"
}
pid_name = {pid: proc for (proc, pid) in names}
by_track: dict = {}
for e in spans:
    key = (pid_name.get(e["pid"], e["pid"]), e["name"])
    calls, dur = by_track.get(key, (0, 0.0))
    by_track[key] = (calls + 1, dur + e["dur"] / 1e6)
print("[trace] process/track        spans  busy(sim s)")
for (proc, name), (calls, dur) in sorted(by_track.items(), key=lambda kv: (-kv[1][0], kv[0]))[:8]:
    print(f"[trace] {proc:>9s}/{name:<12s} {calls:5d}  {dur:8.1f}")

# the cross-layer metrics registry: one line per headline metric
snap = tl.metrics_snapshot()
print("[metr ] cross-layer registry highlights:")
for name in sorted(snap):
    m = snap[name]
    if m["kind"] == "counter":
        print(f"[metr ] {name:<28s} count={m['value']}")
    elif m["kind"] == "histogram" and (
        name.endswith("latency_s") or name.startswith(("tune.", "fabric."))
    ):
        print(
            f"[metr ] {name:<28s} n={m['count']:<5d} "
            f"p50={m['p50']:.4f} p99={m['p99']:.4f}"
        )
