"""Mamba2 SSD chunk scan: the CUDA kernels' wrapper, their plan and the plain version.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas ``_ssd_kernel``):
within each chunk a masked-decay ``(C·Bᵀ ∘ L)·(x·dt)``, across chunks a
carried fp32 ``[P, N]`` state.  On the LM path it is the prefill scan of
every ``ssd`` model, in place of the reference's ``blocks.ssd_chunked``.
Unlike the Pallas kernel it also returns the final state, which
``ssd_block(return_state=True)`` hands to decode.

``csrc/ssd_scan.cu`` holds three forward routes, which :func:`route` picks
by type, shape and alignment alone.  bf16 at chunk 64, p a multiple of 64,
state width 64/128 and rows TMA can address (every served prefill,
training forward and mesh-rank scan) runs parallel over chunks on
``wgmma``: ``ssd_scan_fwd_states_kernel`` carries the state along the
chunks a (batch, head, 64 rows of p, 64 state columns) a block and writes
the state entering each chunk (the body of the backward's states kernel,
run forward alone), then ``ssd_scan_fwd_chunk_kernel`` computes every
chunk's output a (batch, chunk, group of :func:`bwd_head_group` heads) a
block, C·Bᵀ once for the group (:func:`fwd_kernels` names each route's
launches).  Other bf16 at chunk 16/32/64, state width 64/128, p a multiple
of 16 and 16-byte-aligned rows runs ``ssd_scan_mma_bf16_kernel`` (one block
per (batch, head, tile of the state's rows over p) with a loop over chunks
inside, the four chunk products on ``mma.sync``, each operand that is not
exact in bf16 split into bf16 terms, the state in fp32 registers, a
``cp.async`` ring over chunks); everything else, fp32 included, on
``ssd_scan_kernel`` (fp32 FMA on the SIMT pipes, the same structure).
:func:`plan` picks the ``mma.sync`` kernel's p tile from the shape and the
SM count (see the source note for every design).

:func:`ssd_scan_plain` uses the Pallas kernel's fp32 chunk arithmetic in
PyTorch; the CPU path and the on-card checks use it.  :func:`fwd_states_plain`,
:func:`fwd_pass_plain` and :func:`fwd_chunk_plain` are the ``wgmma`` route's
steps (the chunk states, their passing along the chunks, the chunk
outputs), which compose to it, for the CPU tests.

The backward (the reference has none in Pallas: it trains through XLA's
gradient of ``ssd_chunked``): :func:`ssd_scan_bwd` runs more kernels of
``csrc/ssd_scan.cu`` by the route :func:`bwd_route` picks from type, shape
and alignment (:func:`bwd_kernels` names each route's launches).  bf16 at
chunk 64, p 64, state 64 or 128 with 16-byte-aligned rows (every training
and mesh-rank shape) takes ``"wgmma"``, parallel over chunks on the tensor
cores: ``ssd_scan_bwd_states_mma_kernel`` carries the states forward and
their gradients backward over the chunks (given the forward's states,
:func:`ssd_scan_states`' ``h_in``, the gradients alone),
``ssd_scan_bwd_chunk_kernel`` runs each chunk's backward on ``wgmma`` for
a group of :func:`bwd_head_group` heads given both, and
``ssd_scan_bwd_mma_sum_kernel`` sums the groups' partials of dB and dC and
the chunks' of dA in a fixed order.  ``"mma"``, the same with the chunk
kernel on ``mma.sync`` (``ssd_scan_bwd_chunk_mma_kernel``), takes the same
shapes through :func:`run_bwd_route` alone, to be timed beside it.
Everything else, fp32 and the smoke configs' chunk 8 included, takes
``"simt"``: the reverse scan ``ssd_scan_bwd_kernel`` (fp32 on the SIMT
pipes in register tiles) and ``ssd_scan_bwd_sum_kernel`` (see the source
note).  :func:`ssd_scan_bwd_plain` is the same function by its explicit
formulas in fp32, for the CPU tests and the on-card checks;
:func:`bwd_states_plain`, :func:`bwd_chunk_plain` and :func:`bwd_sum_plain`
are what each kernel of the tensor-core routes computes, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

#: launches of the CUDA kernels since this count was last set to 0
launches = 0
#: of those, calls on the wgmma route (each launches its states kernel before its chunk kernel)
wgmma_launches = 0
#: calls of the backward (each launches its route's kernels, :func:`bwd_kernels`) since this count was last set to 0
bwd_launches = 0

#: the kernels of ``csrc/ssd_scan.cu``, indexed by the route code ``ssd_scan_fwd`` takes (route 3 also
#: launches the states kernel first: :func:`fwd_kernels` names every launch)
KERNELS = (
    "ssd_scan_kernel<float>",  # fp32
    "ssd_scan_kernel<__nv_bfloat16>",  # bf16 outside the tensor-core kernels' shapes
    "ssd_scan_mma_bf16_kernel",  # bf16 on mma.sync
    "ssd_scan_fwd_chunk_kernel",  # bf16 on wgmma, parallel over chunks
)
#: route codes of the two bf16 tensor-core routes
MMA, WGMMA = 2, 3
#: what the wgmma route compiles: its chunk, state widths, and the rows of p and state columns a block
#: of its states kernel carries
WGMMA_CHUNK, WGMMA_STATES, WGMMA_TILE = 64, (64, 128), 64
#: state rows over p per block of the SIMT kernel, and of the backward's
SIMT_P_TILE = BWD_P_TILE = 64
#: the backward's largest chunk and state width (its register tiles: 64 rows, 128 columns)
BWD_MAX_CHUNK, BWD_MAX_STATE = 64, 128
#: what the tensor-core kernel compiles: chunks, state widths, p tiles (largest first)
MMA_CHUNKS, MMA_STATES, MMA_P_TILES = (16, 32, 64), (64, 128), (64, 32, 16)
#: bf16 terms the tensor-core kernel splits each product operand that is not exact in bf16 into (SSD_TERMS)
MMA_TERMS = 3
#: the most shared memory a block may use on the H100, and its SMs
MAX_SMEM_BYTES = 232_448
H100_SMS = 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the backward's routes (:func:`bwd_route`)
BWD_ROUTES = ("simt", "mma", "wgmma")
#: what the tensor-core backward compiles: its chunk, p, state widths, and
#: the state columns one block of its states kernel carries
MMA_BWD_CHUNK, MMA_BWD_P, MMA_BWD_STATES, MMA_BWD_SLICE = 64, 64, (64, 128), 64


def _check_shapes(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"need x [b,l,h,p], dt [b,l,h], A [h], B, C [b,l,n]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, l, h, _ = x.shape
    if tuple(dt.shape) != (b, l, h) or A.shape[0] != h or tuple(B.shape[:2]) != (b, l):
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}")
    if chunk < 1 or l % chunk != 0:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD in plain PyTorch, fp32 inside.  x: [b, l, h, p]; dt: [b, l, h];
    A: [h]; B, C: [b, l, n] -> (y [b, l, h, p] in ``x.dtype``, final state
    [b, h, p, n] fp32)."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.float(), dim=2)  # [b, c, cl, h] log decay
    xdt = xf * dtf[..., None]
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    # intra-chunk: L[l, s] = exp(cum_l - cum_s) for l >= s, 0 above the diagonal
    # (masked before the exp: exp of the positive differences above it overflows, and its gradient would be NaN)
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(0, 1, 4, 2, 3)  # [b, c, h, l, s]
    ldec = torch.exp(torch.where(causal, seg, float("-inf")))
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)
    y = torch.einsum("bchls,bcshp->bclhp", g[:, :, None] * ldec, xdt)
    # inter-chunk: the carried state, then its update, in order
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [b, c, cl, h]
    ys = []
    for c in range(nc):
        y_c = y[:, c] + torch.exp(cum[:, c])[..., None] * torch.einsum("bln,bhpn->blhp", Cf[:, c], state)
        ys.append(y_c)
        new = torch.einsum("blhp,bln->bhpn", decay_to_end[:, c, :, :, None] * xdt[:, c], Bf[:, c])
        state = state * torch.exp(cum[:, c, -1])[..., None, None] + new
    return torch.stack(ys, dim=1).reshape(b, l, h, p).to(x.dtype), state


def fwd_states_plain(x, dt, A, B, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk states of the ``wgmma`` route: for each (b, h) and chunk c
    the chunk's own part of the state, dS_c = (x·exp(cum_last − cum)·dt)ᵀ·B
    ([b, h, nc, p, n] fp32), and its decay exp(cum_last) ([b, h, nc])."""
    b, l, h, p = x.shape
    n, nc = B.shape[-1], l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    cum = torch.cumsum(dtf * A.float(), dim=2)  # [b, c, cl, h]
    w = torch.exp(cum[:, :, -1:] - cum) * dtf
    ds = torch.einsum("bclh,bclhp,bcln->bhcpn", w, xf, B.float().reshape(b, nc, chunk, n))
    return ds, torch.exp(cum[:, :, -1]).permute(0, 2, 1)


def fwd_pass_plain(ds: torch.Tensor, dec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The state passing of the ``wgmma`` route, in chunk order in fp32:
    S_c = S_{c−1}·exp(cum_last, c) + dS_c from S_{−1} = 0.  Returns the
    state entering each chunk [b, h, nc, p, n] (zero for the first) and
    the last state [b, h, p, n]."""
    state = torch.zeros_like(ds[:, :, 0])
    entering = []
    for c in range(ds.shape[2]):
        entering.append(state)
        state = state * dec[:, :, c, None, None] + ds[:, :, c]
    return torch.stack(entering, dim=2), state


def fwd_chunk_plain(x, dt, A, B, C, h_in, *, chunk: int = 64) -> torch.Tensor:
    """The chunk outputs of the ``wgmma`` route, each chunk on its own given
    the state entering it (``h_in`` [b, h, nc, p, n], :func:`fwd_pass_plain`):
    Y = (G∘L∘dt)·x + exp(cum)∘(C·H_inᵀ), G = C·Bᵀ shared by every head,
    L[l, s] = exp(cum_l − cum_s) for l ≥ s, else 0.  Returns y [b, l, h, p]
    in x's type."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n, nc = B.shape[-1], l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Cf = C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.float(), dim=2)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]
    ldec = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))  # [b,c,l,s,h]
    g = torch.einsum("bcln,bcsn->bcls", Cf, B.float().reshape(b, nc, chunk, n))
    intra = torch.einsum("bcls,bclsh,bcsh,bcshp->bclhp", g, ldec, dtf, xf)
    inter = torch.exp(cum)[..., None] * torch.einsum("bcln,bhcpn->bclhp", Cf, h_in.float())
    return (intra + inter).reshape(b, l, h, p).to(x.dtype)


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 64):
    """The backward of :func:`ssd_scan_plain` by its explicit formulas in
    fp32 chunk arithmetic.  dy: the gradient of y [b, l, h, p]; dstate: that
    of the final state [b, h, p, n], or None where it is unused.  Returns
    (dx, ddt, dA, dB, dC): dx, dB and dC in their inputs' types, ddt and dA
    fp32.  Per (b, h) and chunk c, with cum the in-chunk cumulative sum of
    dt·A, xdt = x·dt, H_c the state entering chunk c and dH_c its gradient:
    - dH_c = exp(cum_last)·dH_{c+1} + Σ_l exp(cum_l)·dy_l ⊗ C_l, from dstate;
    - dxdt_s = Σ_{l≥s} (C_l·B_s)·exp(cum_l − cum_s)·dy_l + exp(cum_last − cum_s)·dH_{c+1}·B_s;
    - dC_l and dB_s sum over heads (B and C are shared by every head);
    - d(cum) gathers every decay: the masked decay's rows minus its
      columns, the carried state's output, the state update's weights,
      and <dH_{c+1}, H_{c+1}> at the chunk's last step; ddt is its reverse
      in-chunk cumulative sum times A plus dxdt·x, dA that sum times dt."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    dyf = dy.float().reshape(b, nc, chunk, h, p)
    Af = A.float()
    cum = torch.cumsum(dtf * Af, dim=2)  # [b, c, cl, h]
    xdt = xf * dtf[..., None]
    ecum = torch.exp(cum)
    wend = torch.exp(cum[:, :, -1:, :] - cum)  # exp(cum_last - cum_s)
    chunk_dec = torch.exp(cum[:, :, -1])  # [b, c, h]
    # the states entering and leaving each chunk, as the forward carries them
    own = torch.einsum("bclh,bclhp,bcln->bchpn", wend, xdt, Bf)
    states = [torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)]
    for c in range(nc):
        states.append(states[-1] * chunk_dec[:, c, :, None, None] + own[:, c])
    h_in, h_out = torch.stack(states[:-1], dim=1), torch.stack(states[1:], dim=1)  # [b, c, h, p, n]
    # the state's gradient, in reverse: dh_out[:, c] is the gradient of the state leaving chunk c
    into = torch.einsum("bclh,bclhp,bcln->bchpn", ecum, dyf, Cf)
    dh = torch.zeros_like(states[0]) if dstate is None else dstate.float()
    dh_out = [None] * nc
    for c in reversed(range(nc)):
        dh_out[c] = dh
        dh = dh * chunk_dec[:, c, :, None, None] + into[:, c]
    dh_out = torch.stack(dh_out, dim=1)
    # within a chunk: L[l, s] = exp(cum_l - cum_s) for l >= s
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]
    ldec = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))  # [b, c, l, s, h]
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)
    w = ldec * torch.einsum("bclhp,bcshp->bclsh", dyf, xdt)  # L ∘ (dy_l · xdt_s)
    dh_b = torch.einsum("bchpn,bcsn->bcshp", dh_out, Bf)
    dxdt = torch.einsum("bcls,bclsh,bclhp->bcshp", g, ldec, dyf) + wend[..., None] * dh_b
    dc_inter = torch.einsum("bclh,bclhp,bchpn->bclhn", ecum, dyf, h_in)
    dC = torch.einsum("bclsh,bcsn->bcln", w, Bf) + dc_inter.sum(3)
    dB = torch.einsum("bclsh,bcln->bcsn", w, Cf) + torch.einsum("bcsh,bcshp,bchpn->bcsn", wend, xdt, dh_out)
    m = g[..., None] * w  # d(cum_l) gets its row, d(cum_s) loses its column
    dcum = m.sum(3) - m.sum(2)
    dcum = dcum + torch.einsum("bclhn,bcln->bclh", dc_inter, Cf)
    dcum = dcum - wend * (xdt * dh_b).sum(-1)
    dcum[:, :, -1] += (dh_out * h_out).sum((-2, -1))
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])  # reverse in-chunk cumulative sum
    ddt = dla * Af + (dxdt * xf).sum(-1)
    dA = (dla * dtf).sum((0, 1, 2))
    dx = dxdt * dtf[..., None]
    return (dx.reshape(b, l, h, p).to(x.dtype), ddt.reshape(b, l, h), dA,
            dB.reshape(b, l, n).to(B.dtype), dC.reshape(b, l, n).to(C.dtype))


def _chunked(x, dt, A, B, C, dy, chunk: int):
    """x, dy [b, c, cl, h, p], dt [b, c, cl, h], B, C [b, c, cl, n] in fp32,
    and per (b, c, step, h) cum (the in-chunk cumulative sum of dt·A),
    exp(cum) and exp(cum_last − cum)."""
    b, l, h, p = x.shape
    n, nc = B.shape[-1], l // chunk
    xf, dyf = x.float().reshape(b, nc, chunk, h, p), dy.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf, Cf = B.float().reshape(b, nc, chunk, n), C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.float(), dim=2)
    return xf, dyf, dtf, Bf, Cf, cum, torch.exp(cum), torch.exp(cum[:, :, -1:] - cum)


def bwd_states_plain(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 64):
    """What ``ssd_scan_bwd_states_mma_kernel`` computes: for each (b, h)
    and chunk c the state entering the chunk, H_in, and the gradient of the
    state leaving it, dH_out, both [b, h, nc, p, n] fp32.  Each chunk's own
    parts, own_c = (x·exp(cum_last − cum)·dt)ᵀ·B and into_c =
    (dy·exp(cum))ᵀ·C, pass along the chunks by scaled adds: H_in[0] = 0,
    H_in[c + 1] = H_in[c]·exp(cum_last) + own_c; dH_out[nc − 1] = dstate
    (0 where None), dH_out[c − 1] = dH_out[c]·exp(cum_last) + into_c."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n, nc = B.shape[-1], l // chunk
    xf, dyf, dtf, Bf, Cf, cum, ecum, wend = _chunked(x, dt, A, B, C, dy, chunk)
    own = torch.einsum("bclh,bclhp,bcln->bhcpn", wend * dtf, xf, Bf)
    into = torch.einsum("bclh,bclhp,bcln->bhcpn", ecum, dyf, Cf)
    dec = torch.exp(cum[:, :, -1]).permute(0, 2, 1)[..., None, None]  # [b, h, c, 1, 1]
    zero = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_in = [zero]
    for c in range(nc - 1):
        h_in.append(h_in[-1] * dec[:, :, c] + own[:, :, c])
    dh_out = [zero if dstate is None else dstate.float()]
    for c in range(nc - 1, 0, -1):
        dh_out.append(dh_out[-1] * dec[:, :, c] + into[:, :, c])
    return torch.stack(h_in, dim=2), torch.stack(dh_out[::-1], dim=2)


def bwd_chunk_plain(x, dt, A, B, C, dy, h_in, dh_out, *, chunk: int = 64, head_group: int = 1):
    """What ``ssd_scan_bwd_chunk_mma_kernel`` computes, each chunk on its
    own given h_in and dh_out (:func:`bwd_states_plain`).  Per (b, chunk,
    head), with L[l, s] = exp(cum_l − cum_s) for l ≥ s and wend =
    exp(cum_last − cum):
    - W = (dy·xᵀ)∘L∘dt_s and M = (C·Bᵀ)∘W;
    - dxdt = ((C·Bᵀ)∘L)ᵀ·dy + wend∘(B·dH_outᵀ), dx = dxdt·dt;
    - d(cum) = M's row sums − its column sums + Σ_n (exp(cum)∘(dy·H_in))∘C
      − wend·dt·Σ_p x∘(B·dH_outᵀ), plus at the chunk's last step
      <dH_out, H_out> = exp(cum_last)·<dH_out, H_in> + Σ (wend·dt∘(x·dH_out))∘B;
    - ddt = (the reverse in-chunk cumulative sum of d(cum))·A + Σ_p dxdt·x,
      and dA's part, that sum times dt over the chunk;
    and per group of ``head_group`` consecutive heads dC's and dB's parts,
    (Σ W)·B + Σ exp(cum)∘(dy·H_in) and (Σ W)ᵀ·C + Σ wend·dt∘(x·dH_out).
    Returns (dx in x's type, ddt [b, l, h], dA's parts [b, nc, h], dB's and
    dC's parts [b, l, h / head_group, n]), all but dx fp32."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n, nc = B.shape[-1], l // chunk
    if h % head_group:
        raise ValueError(f"head group {head_group} does not divide {h} heads")
    groups = h // head_group
    xf, dyf, dtf, Bf, Cf, cum, ecum, wend = _chunked(x, dt, A, B, C, dy, chunk)
    hin, dho = h_in.float().transpose(1, 2), dh_out.float().transpose(1, 2)  # [b, c, h, p, n]
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]
    ldec = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))  # [b,c,l,s,h]
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)
    w = ldec * torch.einsum("bclhp,bcshp->bclsh", dyf, xf) * dtf[:, :, None]
    m = g[..., None] * w
    dh_b = torch.einsum("bcsn,bchpn->bcshp", Bf, dho)
    dxdt = torch.einsum("bcls,bclsh,bclhp->bcshp", g, ldec, dyf) + wend[..., None] * dh_b
    dc_inter = ecum[..., None] * torch.einsum("bclhp,bchpn->bclhn", dyf, hin)
    db_inter = (wend * dtf)[..., None] * torch.einsum("bcshp,bchpn->bcshn", xf, dho)
    carry = torch.exp(cum[:, :, -1]) * (dho * hin).sum((-2, -1)) + torch.einsum("bcshn,bcsn->bch", db_inter, Bf)
    dcum = (m.sum(3) - m.sum(2) + torch.einsum("bclhn,bcln->bclh", dc_inter, Cf)
            - wend * dtf * (xf * dh_b).sum(-1))
    dcum[:, :, -1] += carry
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = dla * A.float() + (dxdt * xf).sum(-1)
    wg = w.reshape(b, nc, chunk, chunk, groups, head_group).sum(-1)
    pdC = (torch.einsum("bclsg,bcsn->bclgn", wg, Bf)
           + dc_inter.reshape(b, nc, chunk, groups, head_group, n).sum(4))
    pdB = (torch.einsum("bclsg,bcln->bcsgn", wg, Cf)
           + db_inter.reshape(b, nc, chunk, groups, head_group, n).sum(4))
    dx = dxdt * dtf[..., None]
    return (dx.reshape(b, l, h, p).to(x.dtype), ddt.reshape(b, l, h), (dla * dtf).sum(2),
            pdB.reshape(b, l, groups, n), pdC.reshape(b, l, groups, n))


def bwd_sum_plain(pdB, pdC, pdA, dtype: torch.dtype):
    """What ``ssd_scan_bwd_mma_sum_kernel`` computes: dB and dC [b, l, n]
    in ``dtype``, their parts [b, l, groups, n] summed over the groups in
    group order, and dA [h], its parts [b, nc, h] summed over batches and
    chunks in index order."""
    dB, dC = pdB[:, :, 0], pdC[:, :, 0]
    for grp in range(1, pdB.shape[2]):
        dB, dC = dB + pdB[:, :, grp], dC + pdC[:, :, grp]
    parts = pdA.reshape(-1, pdA.shape[-1])
    dA = parts[0]
    for row in parts[1:]:
        dA = dA + row
    return dB.to(dtype), dC.to(dtype), dA


def _tensor_cores_take(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool) -> bool:
    """Whether the tensor-core backward kernels (``"mma"`` and ``"wgmma"``) take this type and shape."""
    return (dtype == torch.bfloat16 and aligned and chunk == MMA_BWD_CHUNK and p == MMA_BWD_P
            and n in MMA_BWD_STATES)


def bwd_route(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool) -> str:
    """The backward's route (one of :data:`BWD_ROUTES`) by type, shape and
    alignment alone: ``"wgmma"`` for bf16 at chunk ``MMA_BWD_CHUNK``, p
    ``MMA_BWD_P`` and a state width of ``MMA_BWD_STATES`` where ``aligned``
    (x, B, C and dy start 16-byte aligned with every stride but the last a
    multiple of 8 elements: every training and mesh-rank shape); ``"simt"``
    for everything else, fp32 and the smoke configs' chunk 8 included.
    ``"mma"``, the ``mma.sync`` chunk kernel the ``"wgmma"`` route
    replaced, takes the same shapes and is reached through
    :func:`run_bwd_route` alone."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    return "wgmma" if _tensor_cores_take(dtype, p, n, chunk, aligned) else "simt"


def bwd_kernels(route: str, dtype: torch.dtype, n: int, tma: bool = True) -> tuple[str, ...]:
    """The kernels one backward of x's type ``dtype`` and state width ``n``
    launches on ``route``, in launch order, as the profiler names them.
    ``tma``: on ``"wgmma"``, whether TMA can address the rows of x, dy, B and
    C (:func:`fwd_aligned`), which picks the chunk kernel's loads."""
    if route == "wgmma":
        return (f"ssd_scan_bwd_states_mma_kernel<{n}>", f"ssd_scan_bwd_chunk_kernel<{n}, {str(tma).lower()}>",
                "ssd_scan_bwd_mma_sum_kernel<__nv_bfloat16>")
    if route == "mma":
        return (f"ssd_scan_bwd_states_mma_kernel<{n}>", f"ssd_scan_bwd_chunk_mma_kernel<{n}>",
                "ssd_scan_bwd_mma_sum_kernel<__nv_bfloat16>")
    if route == "simt":
        t = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}[dtype]
        return f"ssd_scan_bwd_kernel<{t}>", f"ssd_scan_bwd_sum_kernel<{t}>"
    raise ValueError(f"no backward route {route!r} (have {BWD_ROUTES})")


def bwd_head_group(b: int, l: int, h: int, chunk: int = MMA_BWD_CHUNK, sms: int = H100_SMS) -> int:
    """Heads one block of ``ssd_scan_bwd_chunk_mma_kernel`` takes, a pure
    function of the shape and the SM count (one block an SM: its shared
    memory and registers allow no second).  Of the divisors of h that launch
    at least ``sms`` blocks (b · l / chunk · h / group; all divisors where
    none does), the one with the fewest waves of blocks × (group + 1), the
    1 standing for a block's own work (B, C and C·Bᵀ in, the within-chunk
    parts of dB and dC out); ties to the larger group, which writes fewer
    partial bytes.  3 at mamba2-130m's training shape, 10 at zamba2-2.7b's:
    256 blocks each."""
    per = b * (l // chunk)
    divisors = [d for d in range(1, h + 1) if h % d == 0]
    fits = [d for d in divisors if per * (h // d) >= sms] or divisors
    return min(fits, key=lambda d: (-(-per * (h // d) // sms) * (d + 1), -d))


def mma_bwd_smem_bytes(n: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the ``"mma"`` route's states
    kernel and of its chunk kernel at state width ``n`` (``bwd_states_smem``
    and ``bwd_chunk_smem`` in the source).  States: 1 KB of alignment slack,
    a 2-stage ring of x or dy and B or C [64][64] (bf16) and dt in 1 KB,
    3 bf16 planes [64][64] of the scaled B or C, and each of the 4 warps'
    factors.  Chunk: B and C [64][n + 8] (bf16), a 2-stage ring of x, dy
    [64][64 + 8] and dt, H [64][n + 4] and dH [64][n + 8] (fp32; two of
    each at state 64, where the next head's land during this one's work,
    one at 128), 3 bf16 planes [64][64 + 8] of (C·Bᵀ)∘L and then Σ W,
    C·Bᵀ's 10 tiles on and below the diagonal (fp32), each of the 8 warps'
    4 factor rows, and two heads' per-step partials."""
    tile = 64 * (64 + 8) * 2
    states = 1024 + 2 * (2 * 64 * MMA_BWD_SLICE * 2 + 1024) + 3 * 64 * MMA_BWD_SLICE * 2 + 4 * 3 * 64 * 4
    state_bufs = 2 if n <= 64 else 1
    chunk = (2 * 64 * (n + 8) * 2 + 2 * (2 * tile + 64 * 4) + state_bufs * (64 * (n + 4) * 4 + 64 * (n + 8) * 4)
             + 3 * tile + 10 * 256 * 4 + 8 * 4 * 64 * 4 + 2 * (2 * 10 * 16 + 3 * 4 * 64 + 8) * 4)
    return states, chunk


def mma_bwd_grid(b: int, l: int, h: int, n: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """Blocks of the ``"mma"`` route's three kernels: the states kernel one
    per (b, h, ``MMA_BWD_SLICE`` state columns, direction), the chunk kernel
    one per (b, chunk, group of :func:`bwd_head_group` heads), the sum one
    per 256 of dB's elements and dA's."""
    groups = h // bwd_head_group(b, l, h, sms=sms)
    return b * h * (n // MMA_BWD_SLICE) * 2, b * (l // MMA_BWD_CHUNK) * groups, -(-(b * l * n + h) // 256)


def wgmma_bwd_smem_bytes(n: int, head_group: int) -> int:
    """Dynamic shared memory of one block of the ``"wgmma"`` route's chunk
    kernel at state width ``n`` and ``head_group`` heads a block
    (``bwd_wgmma_smem`` in the source; its states kernel is the ``"mma"``
    route's, :func:`mma_bwd_smem_bytes`): 1 KB of alignment slack; C and B
    (n / 64 boxes of 64 rows of 128 bytes each); a 2-stage ring of x and dy
    boxes; 3 bf16 planes of one box ((C·Bᵀ)∘L, at the end Σ W); 3 planes of
    H and 3 of dH (n / 64 boxes each); dx's box for its TMA store; 16 fp32
    values for each of the 256 threads (C·Bᵀ); three barriers and a pad; dt
    of the group's heads; the 8 warps' 3 factor rows; two heads' per-step
    partials."""
    box = 64 * 128
    parts = 2 * 64 + 4 * 64 + 2 * 64 + 2 * 64 + 2 * 64 + 8
    return (1024 + (2 * (n // 64) + 4 + 3 + 6 * (n // 64) + 1) * box + 16 * 256 * 4 + 4 * 8
            + head_group * 64 * 4 + 8 * 3 * 64 * 4 + 2 * parts * 4)


def wgmma_bwd_grid(b: int, l: int, h: int, n: int, carried: bool = False,
                   sms: int = H100_SMS) -> tuple[int, int, int]:
    """Blocks of the ``"wgmma"`` route's three kernels: the states kernel
    one per (b, h, ``MMA_BWD_SLICE`` state columns) in the gradients'
    direction alone where ``carried`` (the forward's states given), else one
    per direction too, as :func:`mma_bwd_grid`; the chunk kernel one of two
    warpgroups per (b, chunk, group of :func:`bwd_head_group` heads); the
    sum one per 256 of dB's elements and dA's."""
    states, chunks, sums = mma_bwd_grid(b, l, h, n, sms=sms)
    return (states // 2 if carried else states), chunks, sums


def simt_smem_bytes(chunk: int, n: int, p_tile: int) -> int:
    """Dynamic shared memory of one ``ssd_scan_kernel`` block (``smem_floats`` in the source)."""
    return 4 * (2 * chunk * (n + 1) + p_tile * (n + 1) + chunk * p_tile + chunk * chunk + 3 * chunk)


def mma_smem_bytes(chunk: int, n: int, p_tile: int) -> int:
    """Dynamic shared memory of one ``ssd_scan_mma_bf16_kernel`` block
    (``mma_smem_bytes`` in the source): a 2-stage ring of x, B, C (bf16,
    rows padded by 8) and dt, the state (fp32), the 10 tiles of the scaled
    C·Bᵀ of a 64-step chunk on and below its diagonal (fp32), each of the 8
    warps' factors."""
    stage = chunk * ((p_tile + 8) + 2 * (n + 8)) * 2 + chunk * 4
    return 2 * stage + p_tile * n * 4 + 10 * 256 * 4 + 8 * 3 * 64 * 4


def _takes(kernel: int, dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool, tma: bool) -> bool:
    """Whether route ``kernel`` of :data:`KERNELS` scans this type and shape."""
    if kernel in (MMA, WGMMA) and not (dtype == torch.bfloat16 and aligned and n in MMA_STATES):
        return False
    if kernel == WGMMA:
        return tma and chunk == WGMMA_CHUNK and p % WGMMA_TILE == 0 and n in WGMMA_STATES
    if kernel == MMA:
        return chunk in MMA_CHUNKS and p % 16 == 0
    return kernel == (0 if dtype == torch.float32 else 1)


def route(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool, tma: bool | None = None) -> int:
    """Index in :data:`KERNELS` of the route that scans x ``[.., p]`` with
    B, C ``[.., n]`` at ``chunk``, by type, shape and alignment alone.
    ``aligned``: x, B and C start 16-byte aligned with every stride but the
    last a multiple of 8 elements (:func:`_aligned`); ``tma``: TMA can
    address their rows too (:func:`fwd_aligned`), ``aligned`` where not
    given (:func:`alignment` gives both).  bf16 at chunk 64, p a multiple of
    64 and state width 64 or 128 with rows TMA can address takes the
    ``wgmma`` route (3), other aligned bf16 at chunks 16/32/64 with p a
    multiple of 16 ``mma.sync`` (2), fp32 and the rest the SIMT kernel (0,
    1)."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    tma = aligned if tma is None else tma
    return next(k for k in (WGMMA, MMA, 0, 1) if _takes(k, dtype, p, n, chunk, aligned, tma))


def fwd_kernels(p: "SsdPlan", n: int) -> tuple[str, ...]:
    """The kernels one forward on plan ``p`` at state width ``n`` launches, in
    launch order, as the profiler names them."""
    if p.route == WGMMA:
        return f"ssd_scan_fwd_states_kernel<{n}>", f"ssd_scan_fwd_chunk_kernel<{n}>"
    if p.route == MMA:
        return (f"ssd_scan_mma_bf16_kernel<{n}, {p.p_tile}>",)
    return (KERNELS[p.route],)


def fwd_smem_bytes(n: int, head_group: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the ``wgmma`` route's states
    kernel and of its chunk kernel at state width ``n`` and ``head_group``
    heads a chunk-kernel block (``bwd_states_smem`` and ``fwd_chunk_smem`` in
    the source).  States: the backward's states kernel's
    (:func:`mma_bwd_smem_bytes`), whose body it runs.  Chunk: 1 KB of
    alignment slack, C and B (n / 64 boxes of 64 rows of 128 bytes each), a
    2-stage ring of x boxes, 3 bf16 planes of the state (n / 64 boxes each),
    the output's box, three barriers and a pad, dt of the group's heads and
    the 4 warps' 3 factor rows."""
    box = 64 * 128
    states = mma_bwd_smem_bytes(n)[0]
    chunk = 1024 + (2 * (n // 64) + 3 + 3 * (n // 64)) * box + 4 * 8 + head_group * 64 * 4 + 4 * 3 * 64 * 4
    return states, chunk


def fwd_grid(b: int, l: int, h: int, p: int, n: int, sms: int = H100_SMS) -> tuple[int, int]:
    """Blocks of the ``wgmma`` route's two kernels: the states kernel one
    per (b, h, 64 rows of p, 64 state columns), the chunk kernel one per
    (b, chunk, group of :func:`bwd_head_group` heads)."""
    return b * h * (p // WGMMA_TILE) * (n // 64), b * (l // WGMMA_CHUNK) * (h // bwd_head_group(b, l, h, sms=sms))


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """How a kernel of :data:`KERNELS` runs one shape: ``p_tile`` rows of the
    state over p a block, ``blocks`` in the grid, ``smem`` bytes a block."""

    route: int
    p_tile: int
    blocks: int
    smem: int


def _plan_of(kernel: int, b: int, h: int, p: int, n: int, chunk: int, p_tile: int) -> SsdPlan:
    """A route's plan: on ``wgmma`` its states kernel's grid and shared memory
    (the chunk kernel's depend on l: :func:`fwd_grid`, :func:`fwd_smem_bytes`)."""
    if kernel == WGMMA:
        return SsdPlan(kernel, p_tile, b * h * (p // p_tile) * (n // 64), fwd_smem_bytes(n, 1)[0])
    blocks = b * h * -(-p // p_tile)
    smem = mma_smem_bytes(chunk, n, p_tile) if kernel == MMA else simt_smem_bytes(chunk, n, p_tile)
    return SsdPlan(kernel, p_tile, blocks, smem)


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, b: int, h: int, p: int, n: int, chunk: int, aligned: bool,
         tma: bool | None = None, sms: int = H100_SMS) -> SsdPlan:
    """The plan for x ``[b, l, h, p]``, B, C ``[b, l, n]`` at ``chunk`` on a
    card of ``sms`` SMs, a pure function of these.  The SIMT kernel takes
    p tiles of :data:`SIMT_P_TILE`, the ``wgmma`` route of
    :data:`WGMMA_TILE`, the ``mma.sync`` kernel :func:`mma_plan`'s
    (``aligned`` and ``tma`` as :func:`route` takes them)."""
    kernel = route(dtype, p, n, chunk, aligned, tma)
    if kernel == MMA:
        return mma_plan(b, h, p, n, chunk, sms)
    return _plan_of(kernel, b, h, p, n, chunk, WGMMA_TILE if kernel == WGMMA else min(p, SIMT_P_TILE))


@functools.lru_cache(maxsize=1024)
def mma_plan(b: int, h: int, p: int, n: int, chunk: int, sms: int = H100_SMS) -> SsdPlan:
    """The ``mma.sync`` kernel's plan, wherever it takes the shape (also
    where :func:`route` picks ``wgmma``, so the two can be timed side by
    side): the largest p tile of :data:`MMA_P_TILES` that still launches a
    block on every SM (a wider tile reads B and C and computes C·Bᵀ for more
    rows at once), else the smallest (``scripts/ssd_probe.py``, PERF.md)."""
    for p_tile in MMA_P_TILES:
        chosen = _plan_of(MMA, b, h, p, n, chunk, p_tile)
        if chosen.blocks >= sms:
            return chosen
    return chosen


def mma_plans(b: int, h: int, p: int, n: int, chunk: int) -> list[SsdPlan]:
    """Every p tile of the tensor-core kernel at this shape (which
    :func:`route` must send there), as :func:`run_plan` takes them."""
    return [_plan_of(2, b, h, p, n, chunk, p_tile) for p_tile in MMA_P_TILES]


def _aligned(t: torch.Tensor) -> bool:
    """Starts 16-byte aligned, every stride but the last a multiple of 8 elements (bf16 rows)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])


def fwd_aligned(*ts: torch.Tensor) -> bool:
    """Whether TMA can address the rows of every tensor (the ``wgmma``
    route's): :func:`_aligned`, and no zero stride over a dim longer than 1."""
    return all(_aligned(t) and all(st > 0 or d == 1 for st, d in zip(t.stride()[:-1], t.shape)) for t in ts)


def alignment(x, B, C) -> tuple[bool, bool]:
    """:func:`route`'s ``aligned`` and ``tma`` for these inputs."""
    return _aligned(x) and _aligned(B) and _aligned(C), fwd_aligned(x, B, C)


def _check(x, dt, A, B, C, chunk: int) -> None:
    ts = (x, dt, A, B, C)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"ssd_scan needs CUDA tensors, got {[str(t.device) for t in ts]}")
    if any(t.device != x.device for t in ts) or x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}, current device cuda:{torch.cuda.current_device()}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, B, C float32 or bfloat16 alike, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes dt and A float32, got {dt.dtype}, {A.dtype}")
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[-1]
    if min(b, l, h, p, n) == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, B {tuple(B.shape)}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1 or not A.is_contiguous():
        raise ValueError("ssd_scan needs unit stride over p (x) and n (B, C) and a contiguous A")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD on the CUDA kernel :func:`plan` picks.  x: [b, l, h, p] float32
    or bfloat16 with unit stride over p; dt: [b, l, h] float32; A: [h]
    float32 contiguous; B, C: [b, l, n] of x's type with unit stride over n
    (other strides free, so slices of one projection pass without a copy)
    -> (y contiguous [b, l, h, p] of x's type, final state [b, h, p, n]
    float32).

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    return ssd_scan_states(x, dt, A, B, C, chunk=chunk)[:2]


def ssd_scan_states(x, dt, A, B, C, *, chunk: int = 64):
    """:func:`ssd_scan`, also returning the states its route wrote on the
    way: on the ``wgmma`` route the state entering each chunk, H_in (fp32
    [b, h, l / chunk, p, n]; chunk 0's slot is not written: that state is
    zero), which :func:`ssd_scan_bwd` takes as ``h_in`` instead of
    rebuilding it; None on the other routes.  Returns (y, final state,
    H_in or None)."""
    _check(x, dt, A, B, C, chunk)
    b, _, h, p = x.shape
    chosen = plan(x.dtype, b, h, p, B.shape[-1], chunk, *alignment(x, B, C), sms=_sm_count(x.device.index))
    return _launch(x, dt, A, B, C, chunk, chosen)


def run_plan(x, dt, A, B, C, chunk: int, p: SsdPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the scan as ``p`` says, which need not be :func:`plan`'s: the
    route :func:`route` picks, or the ``mma.sync`` kernel where it picks
    ``wgmma`` (to time the two side by side), the inputs checked as
    :func:`ssd_scan` checks them, the plan against what the kernels compile."""
    _check(x, dt, A, B, C, chunk)
    b, _, h, pp = x.shape
    n = B.shape[-1]
    aligned, tma = alignment(x, B, C)
    picked = route(x.dtype, pp, n, chunk, aligned, tma)
    routes = {picked, MMA} if picked == WGMMA and _takes(MMA, x.dtype, pp, n, chunk, aligned, tma) else {picked}
    ok = (p.route in routes and p == _plan_of(p.route, b, h, pp, n, chunk, p.p_tile)
          and (p in mma_plans(b, h, pp, n, chunk) if p.route == MMA
               else p.p_tile == (WGMMA_TILE if p.route == WGMMA else min(pp, SIMT_P_TILE))))
    if not ok:
        raise ValueError(f"plan {p} is not one of the routes {sorted(routes)} takes at x {tuple(x.shape)}, n {n}, "
                         f"chunk {chunk}")
    return _launch(x, dt, A, B, C, chunk, p)[:2]


def _launch(x, dt, A, B, C, chunk: int, p: SsdPlan):
    global launches, wgmma_launches
    b, l, h, pp = x.shape
    n = B.shape[-1]
    if p.smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} with state {n} needs {p.smem} B of shared memory per block "
                         f"(at most {MAX_SMEM_BYTES})")
    if p.blocks > 2**31 - 1:
        raise ValueError(f"grid too large for x {tuple(x.shape)}")
    y = torch.empty((b, l, h, pp), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, pp, n), dtype=torch.float32, device=x.device)
    hbuf = None
    hg = 0
    if p.route == WGMMA:
        hg = bwd_head_group(b, l, h, chunk, sms=_sm_count(x.device.index))
        if fwd_smem_bytes(n, hg)[1] > MAX_SMEM_BYTES:
            raise ValueError(f"a group of {hg} heads needs {fwd_smem_bytes(n, hg)[1]} B of shared memory a block")
        # the state entering each chunk, fp32
        hbuf = torch.empty((b, h, l // chunk, pp, n), dtype=torch.float32, device=x.device)
    err = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
        p.route, b, l, h, pp, n, chunk, p.p_tile,
        *x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        None if hbuf is None else hbuf.data_ptr(), hg,
        # the current stream's handle without building a torch.cuda.Stream:
        # at these sizes the host's time to issue a call rivals the card's
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan: {KERNELS[p.route]} ({p}) launch failed: cudaError {err}")
    launches += 1
    wgmma_launches += p.route == WGMMA
    return y, state, hbuf


def bwd_smem_bytes(chunk: int, n: int, p_tile: int) -> int:
    """Dynamic shared memory of one ``ssd_scan_bwd_kernel`` block
    (``bwd_smem_floats`` in the source): B, C, x and dy of a chunk (fp32,
    rows padded by one), the state and its gradient, three [chunk, chunk]
    panels, seven per-step vectors and the reduction's scratch."""
    return 4 * (2 * chunk * (n + 1) + 2 * chunk * (p_tile + 1) + 2 * p_tile * (n + 1) + 3 * chunk * (chunk + 1)
                + 7 * chunk + 32)


def _check_bwd(x, dt, A, B, C, dy, dstate, chunk: int) -> None:
    _check(x, dt, A, B, C, chunk)
    b, _, h, p = x.shape
    n = B.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or dy.stride(3) != 1:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} on {x.device} with unit stride over p, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}, strides {dy.stride()}")
    if dstate is not None and (dstate.shape != (b, h, p, n) or dstate.dtype != torch.float32
                               or dstate.device != x.device or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be contiguous fp32 [{b}, {h}, {p}, {n}] on {x.device}, got {dstate.dtype} "
                         f"{tuple(dstate.shape)} on {dstate.device}")


def ssd_scan_bwd(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 64, h_in=None):
    """The backward on the CUDA kernels: (dx, ddt, dA, dB, dC) of
    :func:`ssd_scan` from its inputs (as :func:`ssd_scan` takes them, B and
    C strided slices included), dy, the gradient of y [b, l, h, p] of x's
    type with unit stride over p, and dstate, that of the final state
    (contiguous fp32 [b, h, p, n]) or None.  The same function as
    :func:`ssd_scan_bwd_plain`; dx, dB and dC contiguous in their inputs'
    type, ddt and dA fp32.  ``h_in``: the states the forward's ``wgmma``
    route wrote on these inputs (:func:`ssd_scan_states`), which the
    ``"wgmma"`` route then reads instead of rebuilding them (the other
    routes rebuild their own).

    Launches the kernels of :func:`bwd_route`'s route
    (:func:`bwd_kernels`) on the current stream without synchronising (one
    count in ``bwd_launches``); every cross-block sum runs in a fixed
    order, so two calls give the same bits.  Raises if the inputs are not
    what the kernels take or a launch is refused.
    """
    _check_bwd(x, dt, A, B, C, dy, dstate, chunk)
    aligned = all(_aligned(t) for t in (x, B, C, dy))
    route = bwd_route(x.dtype, x.shape[3], B.shape[-1], chunk, aligned)
    return _launch_bwd(x, dt, A, B, C, dy, dstate, chunk, route, h_in=h_in)


def run_bwd_route(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 64, route: str, parts: dict | None = None,
                  h_in=None):
    """:func:`ssd_scan_bwd` on ``route``, which need not be
    :func:`bwd_route`'s: ``"simt"`` takes every shape its kernel does (so
    the bf16 training shapes can be timed on it beside the tensor-core
    routes), ``"mma"`` and ``"wgmma"`` only where :func:`bwd_route` picks
    ``"wgmma"``.  ``parts``, a dict, gets a tensor-core route's scratch,
    what each kernel hands the next: ``h_in`` and ``dh_out`` as
    :func:`bwd_states_plain` gives them (each chunk's but the first's and
    the last's, which the chunk kernel takes as 0 and dstate; ``h_in`` is
    the one given where the route reads it), ``pdA``, ``pdB`` and ``pdC``
    as :func:`bwd_chunk_plain`."""
    _check_bwd(x, dt, A, B, C, dy, dstate, chunk)
    aligned = all(_aligned(t) for t in (x, B, C, dy))
    picked = bwd_route(x.dtype, x.shape[3], B.shape[-1], chunk, aligned)
    if route not in BWD_ROUTES or (route != "simt" and picked != "wgmma"):
        raise ValueError(f"the backward of x {tuple(x.shape)}, B {tuple(B.shape)} ({x.dtype}, chunk {chunk}) has "
                         f"no route {route!r}")
    return _launch_bwd(x, dt, A, B, C, dy, dstate, chunk, route, parts, h_in)


def _check_h_in(h_in, x, n: int, chunk: int) -> None:
    b, l, h, p = x.shape
    if (tuple(h_in.shape) != (b, h, l // chunk, p, n) or h_in.dtype != torch.float32 or h_in.device != x.device
            or not h_in.is_contiguous()):
        raise ValueError(f"h_in must be contiguous fp32 [{b}, {h}, {l // chunk}, {p}, {n}] on {x.device}, got "
                         f"{h_in.dtype} {tuple(h_in.shape)} on {h_in.device}")


def _launch_bwd(x, dt, A, B, C, dy, dstate, chunk: int, route: str, parts: dict | None = None, h_in=None):
    global bwd_launches
    b, l, h, p = x.shape
    n = B.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    ddt, dA = torch.empty((b, l, h), **f32), torch.empty((h,), **f32)
    dB, dC = torch.empty((b, l, n), dtype=B.dtype, device=x.device), torch.empty((b, l, n), dtype=C.dtype, device=x.device)
    strides = (*x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1), C.stride(0), C.stride(1), *dy.stride()[:3])
    if route == "wgmma":
        sms = _sm_count(x.device.index)
        hg = bwd_head_group(b, l, h, chunk, sms=sms)
        carried = h_in is not None
        if carried:
            _check_h_in(h_in, x, n, chunk)
        grid = wgmma_bwd_grid(b, l, h, n, carried, sms=sms)
        if max(grid) > 2**31 - 1:
            raise ValueError(f"grid too large for x {tuple(x.shape)}")
        if wgmma_bwd_smem_bytes(n, hg) > MAX_SMEM_BYTES:
            raise ValueError(f"a group of {hg} heads needs {wgmma_bwd_smem_bytes(n, hg)} B of shared memory a block")
        # H_in (the forward's where given: the states kernel then writes dH_out alone) and dH_out of every chunk
        h_in = h_in if carried else torch.empty((b, h, l // chunk, p, n), **f32)
        dh_out = torch.empty((b, h, l // chunk, p, n), **f32)
        pdB, pdC = torch.empty((b, l, h // hg, n), **f32), torch.empty((b, l, h // hg, n), **f32)
        pdA = torch.empty((b, l // chunk, h), **f32)
        err = _bwd_wgmma_kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), h_in.data_ptr(), dh_out.data_ptr(), pdB.data_ptr(), pdC.data_ptr(),
            pdA.data_ptr(), int(carried), int(fwd_aligned(x, B, C, dy)), b, l, h, n, hg, *strides,
            torch._C._cuda_getCurrentRawStream(x.device.index),
        )
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd ({route}) launch failed: error {err}")
        bwd_launches += 1
        if parts is not None:
            parts.update(h_in=h_in, dh_out=dh_out, pdA=pdA, pdB=pdB, pdC=pdC)
        return dx, ddt, dA, dB, dC
    if route == "mma":
        sms = _sm_count(x.device.index)
        hg = bwd_head_group(b, l, h, chunk, sms=sms)
        if max(mma_bwd_grid(b, l, h, n, sms=sms)) > 2**31 - 1:
            raise ValueError(f"grid too large for x {tuple(x.shape)}")
        states = torch.empty((2, b, h, l // chunk, p, n), **f32)  # H_in and dH_out of every chunk
        pdB, pdC = torch.empty((b, l, h // hg, n), **f32), torch.empty((b, l, h // hg, n), **f32)
        pdA = torch.empty((b, l // chunk, h), **f32)
        err = _bwd_mma_kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), states[0].data_ptr(), states[1].data_ptr(), pdB.data_ptr(),
            pdC.data_ptr(), pdA.data_ptr(), b, l, h, n, hg, *strides,
            torch._C._cuda_getCurrentRawStream(x.device.index),
        )
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd ({route}) launch failed: cudaError {err}")
        bwd_launches += 1
        if parts is not None:
            parts.update(h_in=states[0], dh_out=states[1], pdA=pdA, pdB=pdB, pdC=pdC)
        return dx, ddt, dA, dB, dC
    if chunk > BWD_MAX_CHUNK or n > BWD_MAX_STATE:
        raise ValueError(f"the backward takes chunks up to {BWD_MAX_CHUNK} and states up to {BWD_MAX_STATE}, "
                         f"got chunk {chunk}, state {n}")
    pt = min(p, BWD_P_TILE)
    n_pt = -(-p // pt)
    smem = bwd_smem_bytes(chunk, n, pt)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} with state {n} needs {smem} B of shared memory per block in the backward "
                         f"(at most {MAX_SMEM_BYTES})")
    if b * h * n_pt > 2**31 - 1:
        raise ValueError(f"grid too large for x {tuple(x.shape)}")
    hs = torch.empty((b * h * n_pt, l // chunk, pt, n), **f32)
    pdB, pdC = torch.empty((b, l, h * n_pt, n), **f32), torch.empty((b, l, h * n_pt, n), **f32)
    pddt, pdA = torch.empty((b, l, h, n_pt), **f32), torch.empty((b, h, n_pt), **f32)
    err = _bwd_kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), hs.data_ptr(), pdB.data_ptr(), pdC.data_ptr(), pddt.data_ptr(),
        pdA.data_ptr(), _DTYPES[x.dtype], b, l, h, p, n, chunk, pt, *strides,
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd ({route}) launch failed: cudaError {err}")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC


def occupancy(n: int, p_tile: int, chunk: int) -> int:
    """Blocks of ``ssd_scan_mma_bf16_kernel<n, p_tile>`` at ``chunk`` one SM
    of the current card holds at once."""
    fn = library().ssd_scan_mma_occupancy
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    got = fn(n, p_tile, chunk)
    if got < 0:
        raise RuntimeError(f"ssd_scan_mma_bf16_kernel<{n}, {p_tile}> occupancy: cudaError {-got}")
    return got


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def library() -> ctypes.CDLL:
    from .build import library as load

    return load("ssd_scan")


@functools.cache
def _bwd_kernel():
    fn = library().ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_mma_kernel():
    fn = library().ssd_scan_bwd_mma
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_wgmma_kernel():
    fn = library().ssd_scan_bwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    fn = library().ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Work and traffic of one call (the bounds of chip_smoke.py, the dry run's counts)
# ---------------------------------------------------------------------------


def cost(x: torch.Tensor, B: torch.Tensor, chunk: int) -> tuple[float, float]:
    """FLOPs and bytes of one scan: C.B^T once per (batch, chunk) on the
    lower triangle; per (batch, head, chunk) the masked product on the
    triangle, the carried state's output (not for the first chunk, whose
    state is zero) and the state update.  Bytes: x, B, C, y in x's type, dt,
    A and the final state in fp32, each once."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc, tri = l // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * b * nc * n * tri + 2.0 * b * h * (nc * p * tri + (nc - 1) * chunk * n * p + nc * chunk * n * p)
    nbytes = x.element_size() * (2 * x.numel() + 2 * B.numel()) + 4.0 * (b * l * h + h + b * h * p * n)
    return flops, nbytes


def bwd_cost(x: torch.Tensor, B: torch.Tensor, chunk: int, with_state: bool) -> tuple[float, float]:
    """FLOPs and bytes of one backward of the scan.  FLOPs: C.B^T once per
    (batch, chunk) on the lower triangle; per (batch, head, chunk) the two
    triangular products over p ((dy.xdt) and dxdt's within-chunk part), the
    two over n (dC's and dB's within-chunk parts) and five [chunk, p, n]
    products (the state entering the chunk, rebuilt; dH.B; dy.H; x.dH; dH's
    update).  Bytes: x, dy and dx, B, C, dB and dC in x's type; dt, ddt, A,
    dA and (if given) dstate in fp32, each once."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc, tri = l // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * (b * nc * tri * n + b * h * nc * (2 * tri * p + 2 * tri * n + 5 * chunk * p * n))
    nbytes = x.element_size() * (3 * x.numel() + 4 * B.numel()) + 4.0 * (2 * b * l * h + 2 * h
                                                                         + (b * h * p * n if with_state else 0))
    return flops, nbytes
