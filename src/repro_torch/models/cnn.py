"""The paper's CNN workloads: ResNet50, YOLOv3 (Darknet-53), AlexNet, SynthNet.

Two views of each network, as in ``repro/models/cnn.py``:

  1. ``network_layers(name)`` — the per-layer Eq.-1 cost tables the
     scheduler consumes.
  2. :class:`CNNModel` — a runnable network built from the same table, every
     convolution through ``kernels.ops.conv2d_im2col`` (the CUDA kernel on
     the card, its plain version on the CPU).

SynthNet is the paper's synthetic 18-layer network: AlexNet's five conv
layers replicated (channels chained across repeats) to reach 18 layers.
Layouts are the JAX package's, NHWC activations and HWIO weights, so that
its weights load as they are (:meth:`CNNModel.params_from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core.cost_model import Layer, conv_layer
from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    h_out: int
    w_out: int
    c_in: int
    r: int
    s: int
    k: int
    stride: int = 1


def _to_layers(specs: Sequence[ConvSpec]) -> list[Layer]:
    return [
        conv_layer(sp.name, sp.h_out, sp.w_out, sp.c_in, sp.r, sp.s, sp.k)
        for sp in specs
    ]


# ---------------------------------------------------------------------------
# ResNet50 — 50 compute-intensive layers (stem + 16 bottlenecks×3 + fc)
# ---------------------------------------------------------------------------


def resnet50_specs() -> list[ConvSpec]:
    specs = [ConvSpec("stem", 112, 112, 3, 7, 7, 64, stride=2)]
    stage_cfg = [  # (spatial, n_blocks, mid_channels, out_channels)
        (56, 3, 64, 256),
        (28, 4, 128, 512),
        (14, 6, 256, 1024),
        (7, 3, 512, 2048),
    ]
    c_in = 64  # after stem maxpool
    for si, (hw, n_blocks, mid, out) in enumerate(stage_cfg):
        for b in range(n_blocks):
            p = f"s{si + 1}b{b + 1}"
            specs.append(ConvSpec(f"{p}_1x1a", hw, hw, c_in, 1, 1, mid))
            specs.append(ConvSpec(f"{p}_3x3", hw, hw, mid, 3, 3, mid))
            specs.append(ConvSpec(f"{p}_1x1b", hw, hw, mid, 1, 1, out))
            c_in = out
    specs.append(ConvSpec("fc", 1, 1, 2048, 1, 1, 1000))
    assert len(specs) == 50
    return specs


# ---------------------------------------------------------------------------
# YOLOv3 backbone (Darknet-53) — 52 compute-intensive conv layers @416²
# ---------------------------------------------------------------------------


def yolov3_specs() -> list[ConvSpec]:
    specs = [ConvSpec("conv0", 416, 416, 3, 3, 3, 32)]
    c_in = 32
    plan = [  # (spatial after downsample, out_channels, n_residual_blocks)
        (208, 64, 1),
        (104, 128, 2),
        (52, 256, 8),
        (26, 512, 8),
        (13, 1024, 4),
    ]
    for hw, ch, n_res in plan:
        specs.append(ConvSpec(f"down{ch}", hw, hw, c_in, 3, 3, ch, stride=2))
        c_in = ch
        for b in range(n_res):
            specs.append(ConvSpec(f"res{ch}_{b}_1x1", hw, hw, ch, 1, 1, ch // 2))
            specs.append(ConvSpec(f"res{ch}_{b}_3x3", hw, hw, ch // 2, 3, 3, ch))
    assert len(specs) == 52
    return specs


# ---------------------------------------------------------------------------
# AlexNet convs + SynthNet (paper §7.1: AlexNet convs replicated to 18)
# ---------------------------------------------------------------------------


def alexnet_specs(c_in: int = 3, tag: str = "") -> list[ConvSpec]:
    return [
        ConvSpec(f"a{tag}conv1", 55, 55, c_in, 11, 11, 96, stride=4),
        ConvSpec(f"a{tag}conv2", 27, 27, 96, 5, 5, 256),
        ConvSpec(f"a{tag}conv3", 13, 13, 256, 3, 3, 384),
        ConvSpec(f"a{tag}conv4", 13, 13, 384, 3, 3, 384),
        ConvSpec(f"a{tag}conv5", 13, 13, 384, 3, 3, 256),
    ]


def synthnet_specs(n_layers: int = 18) -> list[ConvSpec]:
    specs: list[ConvSpec] = []
    c_in, rep = 3, 0
    while len(specs) < n_layers:
        block = alexnet_specs(c_in, tag=f"r{rep}_")
        specs.extend(block[: n_layers - len(specs)])
        c_in = specs[-1].k
        rep += 1
    return specs


NETWORKS = {
    "resnet50": resnet50_specs,
    "yolov3": yolov3_specs,
    "alexnet": alexnet_specs,
    "synthnet": synthnet_specs,
}


def network_layers(name: str) -> list[Layer]:
    """Per-layer Eq.-1 cost table for a paper network."""
    return _to_layers(NETWORKS[name]())


# ---------------------------------------------------------------------------
# Runnable CNN built from the same spec table
# ---------------------------------------------------------------------------


def resize_nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "nearest")``: on every axis whose size
    changes, output index i reads input index floor((i + 0.5) · in / out),
    computed in float32 as JAX computes it.  Spatially this is
    ``F.interpolate(mode="nearest-exact")``; the reference applies it to
    the channel axis too."""
    for d, n in enumerate(shape):
        m = x.shape[d]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).floor().long()
            x = x.index_select(d, idx)
    return x


class CNNModel(nn.Module):
    """A runnable conv chain (inference) matching a spec table.

    Spatial dims are synthetic (every layer runs at its table resolution via
    resize), which keeps the chain runnable layer by layer — what the
    pipeline runtime needs: each stage applies its own contiguous slice.
    Parameter ``w{i}`` is layer i's HWIO weight, ``b{i}`` its bias.
    """

    def __init__(self, specs: Sequence[ConvSpec], device: str | torch.device = "cuda"):
        super().__init__()
        self.specs = tuple(specs)
        self.w = nn.ParameterList(
            nn.Parameter(torch.empty(sp.r, sp.s, sp.c_in, sp.k, device=device), requires_grad=False)
            for sp in self.specs
        )
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(sp.k, device=device), requires_grad=False) for sp in self.specs
        )

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "CNNModel":
        """Weights N(0, 1/fan_in) and zero biases, as the reference draws
        them, from ``gen`` (a generator on the model's device)."""
        for sp, w, b in zip(self.specs, self.w, self.b):
            w.normal_(generator=gen).div_(float(np.sqrt(sp.c_in * sp.r * sp.s)))
            b.zero_()
        return self

    @torch.no_grad()
    def params_from_numpy(self, params: Sequence[dict[str, np.ndarray]]) -> "CNNModel":
        """Load the reference's ``model.init`` output (one ``{"w", "b"}``
        dict of HWIO / [K] arrays per layer) as it is, with no transpose."""
        if len(params) != len(self.specs):
            raise ValueError(f"{len(params)} parameter sets for {len(self.specs)} layers")
        for p, w, b in zip(params, self.w, self.b):
            w.copy_(torch.tensor(np.asarray(p["w"])))
            b.copy_(torch.tensor(np.asarray(p["b"])))
        return self

    def layer_input(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """``x`` brought to layer i's expected input grid (the reference's
        resize, skipped when height and channels already match)."""
        sp = self.specs[i]
        in_h = sp.h_out * sp.stride
        if x.shape[1] != in_h or x.shape[3] != sp.c_in:
            x = resize_nearest(x, (x.shape[0], in_h, in_h, sp.c_in)).contiguous()
        return x

    @torch.no_grad()
    def apply_layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = ops.conv2d_im2col(self.layer_input(i, x), self.w[i], stride=self.specs[i].stride)
        return torch.relu(y + self.b[i])

    def apply_range(self, x: torch.Tensor, start: int, end: int) -> torch.Tensor:
        for i in range(start, end):
            x = self.apply_layer(i, x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_range(x, 0, len(self.specs))


def canonical_pipeline_apply(model: CNNModel, input_shape: tuple[int, int, int]):
    """Shape-uniform layer application, the reference's stage contract.

    The JAX runner needs every layer to map one canonical zero-padded
    activation [B, Hc, Wc, Cc] to itself (``lax.switch`` branches must
    agree).  The stream runner passes natural shapes and does not need
    this; it is kept so the two contracts can be compared.  Padding + exact
    cropping (never resizing through the pad) keeps the result equal to
    sequential execution.

    Returns (apply_fn, to_canon, crop_out, canon_shape).
    """
    specs = model.specs
    hc = max([input_shape[0]] + [sp.h_out * sp.stride for sp in specs] + [sp.h_out for sp in specs])
    wc = max([input_shape[1]] + [sp.w_out * sp.stride for sp in specs] + [sp.w_out for sp in specs])
    cc = max([input_shape[2]] + [sp.c_in for sp in specs] + [sp.k for sp in specs])
    canon = (hc, wc, cc)

    def to_canon(x):
        return torch.nn.functional.pad(
            x, (0, cc - x.shape[-1], 0, wc - x.shape[-2], 0, hc - x.shape[-3])
        )

    def shape_into(i):
        if i == 0:
            return input_shape
        sp = specs[i - 1]
        return (sp.h_out, sp.w_out, sp.k)

    def apply_fn(i, xc):
        h, w, c = shape_into(i)
        return to_canon(model.apply_layer(i, xc[:, :h, :w, :c].contiguous()))

    def crop_out(xc):
        sp = specs[-1]
        return xc[..., : sp.h_out, : sp.w_out, : sp.k]

    return apply_fn, to_canon, crop_out, canon


def make_cnn(name: str, scale: float = 1.0, device: str | torch.device = "cuda") -> CNNModel:
    """Runnable model; ``scale`` shrinks channels for CPU smoke tests."""
    specs = NETWORKS[name]()
    if scale != 1.0:
        scaled = []
        prev_k = None
        for sp in specs:
            c_in = prev_k if prev_k is not None else sp.c_in
            k = max(8, int(sp.k * scale))
            h = max(4, int(sp.h_out * scale))
            scaled.append(dataclasses.replace(sp, h_out=h, w_out=h, c_in=c_in, k=k))
            prev_k = k
        specs = scaled
    return CNNModel(specs, device=device)
