"""Mamba2 (SSD: state-space duality) blocks, for mamba2-130m and zamba2-7b.

Port of ``repro/models/ssm.py``.  Per head h with state size N and head dim
P:

    h_t = a_t * h_{t-1} + dt_t * (B_t  (x)  x_t)          a_t = exp(dt_t * A_h)
    y_t = C_t . h_t + D_h * x_t

Prefill runs it chunk-parallel: within a chunk of length Q the quadratic
term C_i (prod a) B_j^T handles intra-chunk interactions; a Python loop over
chunks (the JAX ``lax.scan``) carries the [B, H, P, N] state.  Decode steps
the recurrence once per token (``ssm_decode_step``).  The in/out projections
go through ``layers.dense`` (the multi-precision matmul when quantized); the
recurrence stays in float32, as in the JAX package.  Padded steps of the last
chunk are identities of the state: their ``dt`` is 0 (decay 1, update 0).

The intra-chunk decay matrix masks its upper triangle before the
exponential, ``exp(where(tri, li, -inf))``, where the JAX function takes
``where(tri, exp(li), 0)``: the same values (exact zeros above the
diagonal), but above it ``li = cum_i - cum_j`` is positive and its ``exp``
overflows to inf once a chunk's decay is large, and the zero cotangent
``where`` gives those entries makes 0 * inf = NaN in the backward.  So the
port's gradient stays finite where the reference's is NaN (training the
reduced mamba2-130m or zamba2-7b at S >= 64 in float32); this is the one
place where the port leaves the reference's result on purpose.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, dense_init, rms_norm


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int  # = expand * d_model (expand=2)
    n_heads: int  # = d_inner // head_p
    head_p: int  # head dim (P), 64
    state: int  # N


def ssm_dims(d_model: int, state: int, head_p: int = 64, expand: int = 2) -> SSMDims:
    d_inner = expand * d_model
    return SSMDims(d_model, d_inner, d_inner // head_p, head_p, state)


def init_ssm_params(gen: torch.Generator, dims: SSMDims, dtype, *lead: int) -> dict:
    """Random Mamba2 block parameters on ``gen.device``, stacked over
    ``lead`` (e.g. the layer count)."""
    d, di, n, h = dims.d_model, dims.d_inner, dims.state, dims.n_heads
    dev = gen.device
    return {
        # fused input projection: [z (di), x (di), B (n), C (n), dt (H)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + h, dtype, *lead),
        "out_proj": dense_init(gen, di, d, dtype, *lead),
        "A_log": torch.zeros(*lead, h, dtype=torch.float32, device=dev),  # A = -exp(A_log)
        "D": torch.ones(*lead, h, dtype=torch.float32, device=dev),
        "dt_bias": torch.full((*lead, h), math.log(math.e - 1), dtype=torch.float32,
                              device=dev),
        "norm": torch.ones(*lead, di, dtype=torch.float32, device=dev),
    }


def _split_proj(proj: torch.Tensor, dims: SSMDims):
    di, n, h = dims.d_inner, dims.state, dims.n_heads
    return torch.split(proj, [di, di, n, n, h], dim=-1)  # z, x, B, C, dt


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P] f32
    dt: torch.Tensor,  # [B, S, H] f32 (post-softplus)
    a_log: torch.Tensor,  # [H]
    b: torch.Tensor,  # [B, S, N] f32 (shared across heads, n_groups=1)
    c: torch.Tensor,  # [B, S, N]
    chunk: int = 128,
    return_state: bool = False,
):
    """Chunk-parallel SSD; returns y [B, S, H, P] f32 (and the final
    [B, H, P, N] state when ``return_state``: prefill seeds decode with it)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // q
    a = -torch.exp(a_log)  # [H], negative
    loga = dt * a[None, None, :]  # [B, S', H]  log decay per step

    xc = x.reshape(bs, nc, q, h, p)
    dtc = dt.reshape(bs, nc, q, h)
    lac = loga.reshape(bs, nc, q, h)
    bc = b.reshape(bs, nc, q, n)
    cc = c.reshape(bs, nc, q, n)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))

    state = torch.zeros(bs, h, p, n, dtype=x.dtype, device=x.device)
    ys = []
    for ci in range(nc):
        xq, dtq, laq, bq, cq = xc[:, ci], dtc[:, ci], lac[:, ci], bc[:, ci], cc[:, ci]
        cum = torch.cumsum(laq, dim=1)  # [B, q, H] inclusive log-decay
        total = cum[:, -1]  # [B, H]
        # intra-chunk (attention-like, lower-triangular):
        # L[i, j] = exp(cum_i - cum_j) for i >= j; masked before the exp
        li = cum[:, :, None, :] - cum[:, None, :, :]  # [B, q, q, H]
        lmat = torch.exp(torch.where(tri[None, :, :, None], li, -math.inf))
        cb = torch.einsum("bin,bjn->bij", cq, bq)  # [B, q, q]
        gates = cb[..., None] * lmat * dtq[:, None, :, :]  # [B, i, j, H]
        y_intra = torch.einsum("bijh,bjhp->bihp", gates, xq)
        # contribution of the carried state
        y_state = torch.einsum("bin,bhpn,bih->bihp", cq, state, torch.exp(cum))
        # new state: decayed old + sum_j exp(total - cum_j) dt_j B_j x_j
        w = torch.exp(total[:, None, :] - cum) * dtq  # [B, q, H]
        ds = torch.einsum("bjn,bjhp,bjh->bhpn", bq, xq, w)
        state = state * torch.exp(total)[:, :, None, None] + ds
        ys.append(y_intra + y_state)
    y = torch.stack(ys, dim=1).reshape(bs, nc * q, h, p)[:, :s]
    if return_state:
        return y, state
    return y


def _gate_norm_out(params: dict, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """[..., d_inner] f32 SSD output -> gated, normed, projected [..., D]."""
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    y = rms_norm(y, params["norm"].to(dtype))
    return dense(y, params["out_proj"])


def ssm_block_with_state(
    params: dict, x_in: torch.Tensor, dims: SSMDims, chunk: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full Mamba2 block (the caller adds the pre-norm residual):
    [B, S, D] -> ([B, S, D], final [B, H, P, N] state)."""
    proj = dense(x_in, params["in_proj"])
    z, xs, b, c, dtr = _split_proj(proj, dims)
    bsz, s = x_in.shape[0], x_in.shape[1]
    xh = xs.float().reshape(bsz, s, dims.n_heads, dims.head_p)
    dt = F.softplus(dtr.float() + params["dt_bias"])  # [B, S, H]
    y, state = ssd_chunked(xh, dt, params["A_log"], b.float(), c.float(), chunk,
                           return_state=True)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(bsz, s, dims.d_inner)
    return _gate_norm_out(params, y, z, x_in.dtype), state


def ssm_block(params: dict, x_in: torch.Tensor, dims: SSMDims, chunk: int = 128) -> torch.Tensor:
    """:func:`ssm_block_with_state` without the state."""
    return ssm_block_with_state(params, x_in, dims, chunk)[0]


def ssm_decode_step(
    params: dict,
    x_in: torch.Tensor,  # [B, 1, D]
    state: torch.Tensor,  # [B, H, P, N] f32
    dims: SSMDims,
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step; returns ([B, 1, D], new state)."""
    proj = dense(x_in, params["in_proj"])
    z, xs, b, c, dtr = _split_proj(proj, dims)
    bsz = x_in.shape[0]
    xh = xs.float().reshape(bsz, dims.n_heads, dims.head_p)
    dt = F.softplus(dtr.float().reshape(bsz, dims.n_heads) + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a[None, :])  # [B, H]
    bf = b.float().reshape(bsz, dims.state)
    cf = c.float().reshape(bsz, dims.state)
    upd = torch.einsum("bn,bhp,bh->bhpn", bf, xh, dt)
    state_new = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cf, state_new) + params["D"][None, :, None] * xh
    y = y.reshape(bsz, 1, dims.d_inner)
    return _gate_norm_out(params, y, z, x_in.dtype), state_new
