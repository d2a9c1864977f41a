"""Static per-layer cost model (Equation 1 of the paper).

Each conv layer gets a *weight*

    W = H * W_in * C * R * S * K            (MACs of the convolution)

which Algorithm 1 uses as the static load estimate when grouping layers into
pipeline stages.  For the LM-family architectures the same quantity — the
per-layer forward MAC count — is computed from the block structure
(attention + FFN / active experts / SSD; ``models/transformer.py::layer_costs``).
Every layer also carries a byte estimate, used by the
roofline evaluator (``core/evaluator.py``) to model bandwidth-bound layers
on low-bandwidth EPs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Layer:
    """One schedulable unit of the network chain.

    ``flops``        — forward FLOPs for one inference unit (image/microbatch).
    ``bytes_mem``    — bytes moved from the EP's memory (weights + act streams).
    ``act_bytes``    — output-activation bytes shipped to the next stage.
    ``weight_bytes`` — resident parameter bytes; what a placement move ships
                       over the fabric when the layer's stage is relocated.
    """

    name: str
    flops: float
    bytes_mem: float
    act_bytes: float
    kind: str = "conv"
    weight_bytes: float = 0.0

    @property
    def weight(self) -> float:
        """Eq. 1 weight (static load estimate); flops stand in for MACs,
        a constant factor that does not change any ranking or merge."""
        return self.flops


def conv_layer(
    name: str,
    h: int,
    w: int,
    c: int,
    r: int,
    s: int,
    k: int,
    *,
    stride: int = 1,
    dtype_bytes: int = 4,
) -> Layer:
    """Build a Layer from conv dims, Eq. 1 of the paper.

    H, W are *output* spatial dims of the conv, the output-centred
    convention of the Im2Col+GEMM operator the paper simulates.
    """
    ho, wo = h // stride, w // stride
    macs = ho * wo * c * r * s * k
    weight_bytes = c * r * s * k * dtype_bytes
    in_bytes = h * w * c * dtype_bytes
    out_bytes = ho * wo * k * dtype_bytes
    # Im2Col materializes the patch matrix: dominant memory stream.
    im2col_bytes = ho * wo * c * r * s * dtype_bytes
    return Layer(
        name=name,
        flops=2.0 * macs,
        bytes_mem=weight_bytes + in_bytes + out_bytes + im2col_bytes,
        act_bytes=out_bytes,
        kind="conv",
        weight_bytes=weight_bytes,
    )


# ---------------------------------------------------------------------------
# Transformer-family layer costs (generalized Eq. 1)
# ---------------------------------------------------------------------------


def attention_layer(
    name: str,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    seq: int,
    *,
    batch: int = 1,
    window: int | None = None,
    dtype_bytes: int = 2,
) -> Layer:
    head_dim = d_model // n_heads
    kv_dim = n_kv_heads * head_dim
    t = batch * seq
    proj = 2.0 * t * (d_model * d_model + 2 * d_model * kv_dim + d_model * d_model)
    ctx = min(seq, window) if window else seq
    attn = 2.0 * batch * n_heads * seq * ctx * head_dim * 2  # QK^T + PV
    w_bytes = (2 * d_model * d_model + 2 * d_model * kv_dim) * dtype_bytes
    act = t * d_model * dtype_bytes
    return Layer(
        name=name,
        flops=proj + attn,
        bytes_mem=w_bytes + 4 * act,
        act_bytes=act,
        kind="attn",
        weight_bytes=w_bytes,
    )


def ffn_layer(
    name: str,
    d_model: int,
    d_ff: int,
    *,
    seq: int,
    batch: int = 1,
    gated: bool = True,
    n_experts: int = 0,
    top_k: int = 0,
    dtype_bytes: int = 2,
) -> Layer:
    t = batch * seq
    mats = 3 if gated else 2
    dense_flops = 2.0 * t * mats * d_model * d_ff
    if n_experts:
        flops = dense_flops * top_k  # active experts only (MoE)
        w_bytes = n_experts * mats * d_model * d_ff * dtype_bytes
        kind = "moe"
    else:
        flops = dense_flops
        w_bytes = mats * d_model * d_ff * dtype_bytes
        kind = "ffn"
    act = t * d_model * dtype_bytes
    return Layer(name=name, flops=flops, bytes_mem=w_bytes + 4 * act, act_bytes=act, kind=kind, weight_bytes=w_bytes)


def ssd_layer(
    name: str,
    d_model: int,
    ssm_state: int,
    *,
    seq: int,
    batch: int = 1,
    expand: int = 2,
    dtype_bytes: int = 2,
) -> Layer:
    """Mamba2 SSD block: in/out projections + chunked state-space scan."""
    d_inner = expand * d_model
    t = batch * seq
    proj = 2.0 * t * (d_model * 2 * d_inner + d_inner * d_model)
    scan = 2.0 * t * d_inner * ssm_state * 3  # B-expand, state update, C-contract
    w_bytes = (3 * d_model * d_inner + d_inner * ssm_state * 2) * dtype_bytes
    act = t * d_model * dtype_bytes
    return Layer(name=name, flops=proj + scan, bytes_mem=w_bytes + 4 * act, act_bytes=act, kind="ssd", weight_bytes=w_bytes)


def fuse(name: str, layers: Sequence[Layer], kind: str = "block") -> Layer:
    """Fuse sub-layers into one schedulable block (attn+ffn => one layer)."""
    return Layer(
        name=name,
        flops=sum(l.flops for l in layers),
        bytes_mem=sum(l.bytes_mem for l in layers),
        act_bytes=layers[-1].act_bytes,
        kind=kind,
        weight_bytes=sum(l.weight_bytes for l in layers),
    )


def weights(layers: Sequence[Layer]) -> list[float]:
    """The paper's W_l list."""
    return [l.weight for l in layers]


def total_flops(layers: Sequence[Layer]) -> float:
    return sum(l.flops for l in layers)
