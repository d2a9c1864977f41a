"""Quickstart on the port: schedule a CNN pipeline with Shisha in ~20 lines.

    PYTHONPATH=src python examples/quickstart_torch.py

The twin of ``examples/quickstart.py`` over ``repro_torch.core``: ResNet50's
layer cost table (Eq. 1), a heterogeneous 8-EP platform, seed generation
(Alg. 1) + online tuning (Alg. 2, heuristic H3), against Hill Climbing under
identical online cost accounting.  It prints the same numbers.
"""

from repro_torch.core import (
    DatabaseEvaluator,
    Trace,
    hill_climbing,
    paper_platform,
    run_shisha,
    space_size,
    weights,
)
from repro_torch.models.cnn import network_layers

layers = network_layers("resnet50")  # 50 compute-intensive layers
platform = paper_platform(8)  # 4 fast + 4 slow EPs (big.LITTLE-style)

trace = Trace(DatabaseEvaluator(platform, layers))
result = run_shisha(weights(layers), trace, heuristic="H3")

print("Shisha (H3) on ResNet50, 8 EPs")
print(f"  design space     : {space_size(len(layers), 8):.2e} configurations")
print(f"  explored         : {trace.n_trials} ({trace.n_trials / space_size(len(layers), 8) * 100:.5f}%)")
print(f"  best schedule    : {result.result.best_conf.pretty([ep.name for ep in platform.eps])}")
print(f"  throughput       : {result.result.best_throughput:.3f} inferences/s (modeled)")
print(f"  online time spent: {trace.wall:.1f}s (simulated pipeline time)")

hc_trace = Trace(DatabaseEvaluator(platform, layers))
hc = hill_climbing(hc_trace, len(layers), budget_s=trace.wall * 35)
print("\nHill Climbing with a 35x larger online budget")
print(f"  explored         : {hc_trace.n_trials}")
print(f"  throughput       : {hc.best_throughput:.3f} ({hc.best_throughput / result.result.best_throughput * 100:.1f}% of Shisha)")
