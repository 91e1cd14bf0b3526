"""Shared NN building blocks: norms, RoPE, embeddings, dense / quantized dense.

Port of ``repro/models/layers.py``.  Parameters are plain dicts of tensors;
a quantized weight is a dict ``{"data", "scale", "bits"}`` (int4 payloads
packed along K, per-output-channel f32 scales) consumed by
``kernels.ops.mpmm``: the hand-written dequant kernel on the card, its
plain version on the CPU.  Unquantized weights stay ``torch.matmul``, as the
JAX package leaves that product to XLA.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ops

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * gamma`` with the variance in f32, the
    rsqrt cast to x.dtype before the products (the JAX order of casts;
    callers cast gamma to x.dtype)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, dtype, *lead: int
) -> torch.Tensor:
    """N(0, 1/d_in) weights [*lead, d_in, d_out] drawn in f32 on gen's device."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """Dense matmul dispatching on plain vs quantized weights: quantized
    dicts go through the multi-precision mpmm (f32 accumulate, per-column
    scale in f32, one cast to x.dtype)."""
    if isinstance(w, dict):
        bits = int(w["bits"])
        if bits >= 16:
            raise NotImplementedError(
                "16-bit quantized weights need int-mode mpmm, not ported yet "
                "(ROADMAP Queue 2: FF/int-mode mpmm)"
            )
        return ops.mpmm(x, w["data"], w["scale"], w_bits=bits).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def quantize_dense_weight(w: torch.Tensor, bits: int) -> dict:
    data, scale = ops.pack_weights(w.float(), bits)
    return {"data": data, "scale": scale, "bits": int(bits)}


# ------------------------------------------------------------------ RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D], positions: [B, S] int.  Rotate-half convention (the
    two halves of D, not interleaved pairs), computed in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
