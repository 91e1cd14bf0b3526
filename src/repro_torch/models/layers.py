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
from repro_torch.kernels import ref as ref_mod

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
    """N(0, 1/d_in) weights [*lead, d_in, d_out] on gen's device, each
    [d_in, d_out] matrix drawn in f32 on its own, so a stack of full-width
    layers never needs an f32 copy of the whole stack."""
    out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=gen.device)
    for w in out.view(-1, d_in, d_out):
        w.copy_(torch.randn((d_in, d_out), generator=gen, device=gen.device)
                * (1.0 / math.sqrt(d_in)))
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """Dense matmul dispatching on plain vs quantized weights: quantized
    dicts go through the multi-precision mpmm (f32 accumulate, per-column
    scale in f32, one cast to x.dtype).

    A 16-bit dict runs in int mode, as the reference does: ``x`` truncated
    toward zero to int32, the exact int32 product (mod 2^32), times the f32
    scale, cast to x.dtype.  That is the int mode's plain version, which
    takes any integer x; the card's int kernel takes int8 / int16 x only,
    and a truncated float activation may not fit int16, so on the card a
    16-bit dict raises."""
    if isinstance(w, dict):
        bits = int(w["bits"])
        if bits < 16:
            return ops.mpmm(x, w["data"], w["scale"], w_bits=bits).to(x.dtype)
        if ops.on_card(x):
            raise ValueError(
                f"16-bit quantized weights run in int mode; the card's int kernel takes "
                f"int8 / int16 activations, got {x.dtype}")
        k, n = x.shape[-1], w["data"].shape[-1]
        acc = ref_mod.mpmm_ref(x.reshape(-1, k).to(torch.int32), w["data"], w["scale"],
                               w_bits=bits, mode="int")
        return (acc.float() * w["scale"].float()).reshape(*x.shape[:-1], n).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def quantize_dense_weight(w: torch.Tensor, bits: int) -> dict:
    """Per-output-channel quantization of a [K, N] weight, or of a stack
    [L, ..., K, N] one matrix at a time (the matrices quantize independently,
    so the bytes are those of one call on the stack, without its f32 copy)."""
    if w.ndim == 2:
        data, scale = ops.pack_weights(w.float(), bits)
        return {"data": data, "scale": scale, "bits": int(bits)}
    mats = w.reshape(-1, *w.shape[-2:])
    data = scale = None
    for i, m in enumerate(mats):
        d_i, s_i = ops.pack_weights(m.float(), bits)
        if data is None:
            data = d_i.new_empty((len(mats), *d_i.shape))
            scale = s_i.new_empty((len(mats), *s_i.shape))
        data[i], scale[i] = d_i, s_i
    return {"data": data.reshape(*w.shape[:-2], *data.shape[1:]),
            "scale": scale.reshape(*w.shape[:-2], *scale.shape[1:]), "bits": int(bits)}


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
