"""Flash-decode GQA attention over a contiguous int8/int4 KV cache: the CUDA
kernel's wrapper and its plain version.

The kernel (``csrc/mqa_decode.cu``) replaces
``repro/kernels/mqa_decode.py::mqa_decode_pallas``: one query token per row
against the row's first ``lengths[b]`` cached tokens, K/V dequantized in
registers with their per-(token, head) scales.  It is bound by the live K/V
bytes.  Each row's positions are split across blocks and a second launch
merges the splits in a fixed order; see the source note for its design.  The
plain version is :func:`repro_torch.kernels.ref.mqa_decode_ref`, which the
dispatch wrapper (``ops.mqa_decode``) runs for CPU tensors.

``mqa_decode_cuda.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect
from repro_torch.kernels.paged_decode import decode_splits
from repro_torch.kernels.ref import mqa_decode_ref

__all__ = ["mqa_decode_cuda", "mqa_decode_ref"]

_TILE_TOKENS = 32  # tokens per tile of the kernel (MQA_KT): splits cover whole tiles


def mqa_decode_cuda(
    q: torch.Tensor,  # [B, Hkv, G, D] bf16 or f32
    k_data: torch.Tensor,  # [B, S, Hkv, D (/2 if kv_bits==4)] int8
    v_data: torch.Tensor,
    k_scale: torch.Tensor,  # [B, S, Hkv, 1] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    *,
    kv_bits: int,
    sm_scale: float,
) -> torch.Tensor:
    """Launch the decode kernel; returns [B, Hkv, G, D] in q's dtype."""
    b, hkv, g, d = q.shape
    s = k_data.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("mqa_decode_cuda takes CUDA tensors")
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    dk = d // 2 if kv_bits == 4 else d
    if d % 2 or dk % 4:
        raise ValueError(f"K/V rows of {dk} bytes (head dim {d}) are not whole 32-bit words")
    expect(q, "q", q.dtype, (b, hkv, g, d), dev)
    for name, t in (("k_data", k_data), ("v_data", v_data)):
        expect(t, name, torch.int8, (b, s, hkv, dk), dev, align=4)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        expect(t, name, torch.float32, (b, s, hkv, 1), dev, align=4)
    expect(lengths, "lengths", torch.int32, (b,), dev)
    splits, per_split = decode_splits(s, _TILE_TOKENS)
    out = torch.empty_like(q)
    part = torch.empty((b, hkv, splits, g * (d + 2)), dtype=torch.float32, device=dev)
    err = _build.lib().mqa_decode(
        q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, s, hkv, g, d, kv_bits, int(q.dtype == torch.float32), splits, per_split,
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "mqa_decode")
    mqa_decode_cuda.launches += 1
    return out


mqa_decode_cuda.launches = 0
