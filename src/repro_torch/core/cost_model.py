"""Static per-layer cost model (Equation 1 of the paper).

Each conv layer gets a *weight*

    W = H * W_in * C * R * S * K            (MACs of the convolution)

which Algorithm 1 uses as the static load estimate when grouping layers into
pipeline stages.  Every layer also carries a byte estimate, used by the
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


def weights(layers: Sequence[Layer]) -> list[float]:
    """The paper's W_l list."""
    return [l.weight for l in layers]
