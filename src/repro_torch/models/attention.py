"""Paged attention entry points of the serving path (port of the paged part
of ``repro/models/attention.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, Dk]  (int8 payload or bf16)
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    lengths: torch.Tensor,  # [B] int32 — tokens already in the cache
    layer: int,  # which pool layer this block attends against
    new_k: torch.Tensor,  # [B, Hkv, Dk] this step's K/V (not yet in the pool)
    new_v: torch.Tensor,
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, P, ps, Hkv, 1] when quantized
    v_scale: Optional[torch.Tensor] = None,
    new_k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, 1]
    new_v_scale: Optional[torch.Tensor] = None,
    kv_bits: int = 16,
) -> torch.Tensor:
    """One-token attention straight against the paged KV pool: each row reads
    only the pages holding its ``lengths[b]`` cached tokens, and the token
    being decoded enters the softmax as an extra term, so the softmax spans
    ``lengths + 1`` positions (kernels/ops.py::paged_mqa_decode)."""
    b, _, h, d = q.shape
    out = ops.paged_mqa_decode(
        q.reshape(b, h, d), k_pool, v_pool, k_scale, v_scale, tables, lengths,
        layer, new_k, new_v, new_k_scale, new_v_scale,
        kv_bits=kv_bits, window=window,
    )
    return out.reshape(b, 1, h, d)


def paged_prefill_attention(
    q: torch.Tensor,  # [B, C, H, D] — a chunk of C query tokens
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, Dk]  (int8 payload or bf16)
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    ctx_lens: torch.Tensor,  # [B] int32 — tokens already in the pool
    q_lens: torch.Tensor,  # [B] int32 — valid chunk tokens per row (<= C)
    layer: int,
    chunk_k: torch.Tensor,  # [B, C, Hkv, Dk] this chunk's K/V (not yet pooled)
    chunk_v: torch.Tensor,
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, P, ps, Hkv, 1] when quantized
    v_scale: Optional[torch.Tensor] = None,
    chunk_k_scale: Optional[torch.Tensor] = None,  # [B, C, Hkv, 1]
    chunk_v_scale: Optional[torch.Tensor] = None,
    kv_bits: int = 16,
) -> torch.Tensor:
    """Chunked-prefill attention straight against the paged KV pool: chunk
    token c sits at position ``ctx_lens[b] + c`` and attends to every pooled
    token before it plus the chunk itself causally
    (kernels/ops.py::paged_mqa_prefill)."""
    return ops.paged_mqa_prefill(
        q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, layer,
        chunk_k, chunk_v, chunk_k_scale, chunk_v_scale,
        kv_bits=kv_bits, window=window,
    )
