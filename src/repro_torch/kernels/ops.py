"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

They keep the JAX package's layouts at the public functions and handle what
the raw kernels do not: weight packing and quantization, KV quantization,
the query regrouping for GQA, and device dispatch.  Dispatch rule: a tensor
on the CPU goes to the kernel's plain version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, or raises.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.precision import Precision
from repro_torch.kernels import mpmm as mpmm_mod
from repro_torch.kernels import paged_decode as decode_mod
from repro_torch.kernels import paged_prefill as prefill_mod
from repro_torch.kernels import ref as ref_mod
from repro_torch.quant.pack import pack_int4

__all__ = [
    "pack_weights",
    "quantize_kv",
    "mpmm",
    "paged_mqa_decode",
    "paged_mqa_prefill",
]

_INT_DTYPE = {4: torch.int8, 8: torch.int8, 16: torch.int16}


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain
    version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def pack_weights(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of a [..., K, N] weight.

    Returns (w_data, w_scale): w_data is [..., K, N] int8/int16, or
    [..., K//2, N] int8 with two K-consecutive nibbles per byte when
    bits == 4; w_scale is [..., 1, N] f32.  Leading dims quantize
    independently (the JAX package vmaps over stacked layers).
    """
    prec = Precision.from_bits(bits)
    amax = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True), 1e-30)
    scale = (amax / prec.spec.qmax).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), prec.spec.qmin, prec.spec.qmax)
    q = q.to(_INT_DTYPE[bits])
    if bits == 4:
        q = pack_int4(q, dim=-2)
    return q, scale


def quantize_kv(kv: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, Hkv, D] float -> (int8 payload [B, S, Hkv, D or D//2], scale
    [B, S, Hkv, 1] f32): per-(token, head) symmetric scales.  As in the JAX
    version the max and its division by qmax run in ``kv``'s dtype."""
    prec = Precision.from_bits(bits)
    amax = torch.clamp_min(kv.abs().amax(dim=-1, keepdim=True), 1e-30)
    scale = (amax / prec.spec.qmax).to(torch.float32)
    q = torch.clamp(torch.round(kv / scale), prec.spec.qmin, prec.spec.qmax)
    q = q.to(torch.int8)
    if bits == 4:
        q = pack_int4(q, dim=-1)
    return q, scale


def mpmm(
    x: torch.Tensor,
    w_data: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    w_bits: int,
    x_bits: int = 16,
    mode: str = "dequant",
    dataflow: str = "cf",
) -> torch.Tensor:
    """Multi-precision matmul: x [..., K] @ dequant(w) -> [..., N] in
    x.dtype (dequant mode, CF order)."""
    if mode != "dequant":
        raise NotImplementedError(
            "mpmm int mode (radix-256 digit planes) is not ported yet "
            "(ROADMAP Queue 2: FF/int-mode mpmm)"
        )
    if dataflow != "cf":
        raise NotImplementedError(
            f"mpmm dataflow={dataflow!r}: only the CF order is ported "
            "(ROADMAP Queue 2: FF/int-mode mpmm)"
        )
    if w_bits == 16:
        raise ValueError("w16 requires int mode (bf16 cannot hold int16 exactly)")
    if x_bits != 16:
        raise ValueError(f"dequant mode takes 16-bit activations, got x_bits={x_bits}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if on_card(x2):
        out = mpmm_mod.mpmm_cuda(x2.contiguous(), w_data, w_scale, w_bits=w_bits)
    else:
        out = ref_mod.mpmm_ref(x2, w_data, w_scale, w_bits=w_bits)
    return out.reshape(*lead, w_data.shape[-1])


def paged_mqa_decode(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, D (/2 if kv_bits==4)]
    v_pool: torch.Tensor,
    k_scale,  # [L, P, ps, Hkv, 1] f32, or None when kv_bits == 16
    v_scale,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    lengths: torch.Tensor,  # [B] int32 — tokens already in the cache
    layer: int,  # pool layer to attend against
    new_k: torch.Tensor,  # [B, Hkv, D (/2)] this step's token, not yet stored
    new_v: torch.Tensor,
    new_k_scale=None,  # [B, Hkv, 1] f32, or None
    new_v_scale=None,
    *,
    kv_bits: int = 8,
    window=None,
) -> torch.Tensor:
    """Single-token GQA attention straight against the paged KV pool.

    Query head h = kv * G + g of ``q [B, H, D]`` is regrouped to
    ``[B, Hkv, G, D]`` for the kernel; ``sm_scale = 1/sqrt(D)``."""
    b, h, d = q.shape
    hkv = k_pool.shape[3]
    sm_scale = 1.0 / math.sqrt(d)
    if not on_card(q):
        return ref_mod.paged_mqa_decode_ref(
            q, k_pool, v_pool, k_scale, v_scale, tables, lengths, layer,
            new_k, new_v, new_k_scale, new_v_scale,
            sm_scale=sm_scale, kv_bits=kv_bits, window=window,
        )
    qg = q.reshape(b, hkv, h // hkv, d).contiguous()
    out = decode_mod.paged_mqa_decode_cuda(
        qg, k_pool, v_pool, k_scale, v_scale, tables, lengths, layer,
        new_k.contiguous(), new_v.contiguous(),
        None if new_k_scale is None else new_k_scale.contiguous(),
        None if new_v_scale is None else new_v_scale.contiguous(),
        kv_bits=kv_bits, sm_scale=sm_scale, window=window,
    )
    return out.reshape(b, h, d)


def paged_mqa_prefill(
    q: torch.Tensor,  # [B, C, H, D] — a chunk of C query tokens per row
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, D (/2 if kv_bits==4)]
    v_pool: torch.Tensor,
    k_scale,  # [L, P, ps, Hkv, 1] f32, or None when kv_bits == 16
    v_scale,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    ctx_lens: torch.Tensor,  # [B] int32 — tokens already in the pool
    q_lens: torch.Tensor,  # [B] int32 — valid chunk tokens per row
    layer: int,  # pool layer to attend against
    chunk_k: torch.Tensor,  # [B, C, Hkv, D (/2)] this chunk's K, not yet stored
    chunk_v: torch.Tensor,
    chunk_k_scale=None,  # [B, C, Hkv, 1] f32, or None
    chunk_v_scale=None,
    *,
    kv_bits: int = 8,
    window=None,
) -> torch.Tensor:
    """Chunked-prefill GQA attention straight against the paged KV pool.

    For the kernel ``q [B, C, H, D]`` becomes ``[B, Hkv, C, G, D]`` and the
    chunk K/V ``[B, Hkv, C, Dk]``, as in the JAX wrapper; the output comes
    back as [B, C, H, D]."""
    b, c, h, d = q.shape
    hkv = k_pool.shape[3]
    sm_scale = 1.0 / math.sqrt(d)
    if not on_card(q):
        return ref_mod.paged_mqa_prefill_ref(
            q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, layer,
            chunk_k, chunk_v, chunk_k_scale, chunk_v_scale,
            sm_scale=sm_scale, kv_bits=kv_bits, window=window,
        )
    qg = q.reshape(b, c, hkv, h // hkv, d).permute(0, 2, 1, 3, 4).contiguous()

    def t(x):
        return None if x is None else x.transpose(1, 2).contiguous()

    out = prefill_mod.paged_mqa_prefill_cuda(
        qg, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, layer,
        t(chunk_k), t(chunk_v), t(chunk_k_scale), t(chunk_v_scale),
        kv_bits=kv_bits, sm_scale=sm_scale, window=window,
    )
    return out.permute(0, 2, 1, 3, 4).reshape(b, c, h, d)
