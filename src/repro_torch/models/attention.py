"""Attention of the serving paths (port of ``repro/models/attention.py``).

``flash_attention`` (prefill of the static-wave path) is the JAX package's
blockwise online softmax in plain PyTorch, in the same block order; the JAX
one is pure JAX too, not a Pallas kernel.  ``decode_attention`` attends one
token to a contiguous cache: its quantized branch is ``ops.mqa_decode``, the
hand-written kernel on the card.  The paged entry points serve the
continuous-batching engine; the verify entry point of speculative decoding
is the paged prefill kernel on a causal window.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops

BLOCK_Q = 512
BLOCK_K = 512
_NEG = -1e30


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*groups, D] by repeat (GQA share)."""
    return k.repeat_interleave(groups, dim=2) if groups > 1 else k


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (None = global)
    q_offset: int = 0,  # absolute position of q[0] (prefill continuation)
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """Online softmax over key blocks, so no [Sq, Sk] score matrix exists
    for more than one key block at a time; f32 scores and sums, output in
    q.dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    sm = 1.0 / math.sqrt(d)
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    pq, pk = (-sq) % bq, (-sk) % bk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = q.shape[1] // bq, k.shape[1] // bk
    dev = q.device

    kb = _expand_kv(k, groups).reshape(b, nk, bk, h, d)
    vb = _expand_kv(v, groups).reshape(b, nk, bk, h, d)
    qb = q.reshape(b, nq, bq, h, d).float()
    q_pos = (q_offset + torch.arange(nq, device=dev)[:, None] * bq
             + torch.arange(bq, device=dev)[None, :])  # [nq, bq]

    m = torch.full((b, nq, bq, h), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nq, bq, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, bq, h, d), dtype=torch.float32, device=dev)
    for kidx in range(nk):
        kc, vc = kb[:, kidx].float(), vb[:, kidx].float()
        scores = torch.einsum("bnqhd,bkhd->bnqhk", qb, kc) * sm  # [B,nq,bq,H,bk]
        k_pos = kidx * bk + torch.arange(bk, device=dev)
        mask = (k_pos < sk)[None, None, :]  # mask the padded tail
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
        mask_b = mask[None, :, :, None, :]  # [1, nq, bq, 1, bk]
        scores = torch.where(mask_b, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(mask_b, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnqhk,bkhd->bnqhd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    out = out.reshape(b, nq * bq, h, d)[:, :sq]
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]  (model dtype, or int8 payload)
    v_cache: torch.Tensor,
    length,  # [B] tensor or int: current cache fill
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [B, S, Hkv, 1] when quantized
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token attention over a contiguous cache.

    With scales (an int8 cache) and no window this is ``ops.mqa_decode``:
    the hand-written kernel for a CUDA tensor, its plain version on the CPU.
    The kernel has no window (nor has the JAX package's), so a windowed
    quantized cache, like an unquantized one, takes the plain computation of
    the JAX function."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    groups = h // hkv
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    lengths = lengths.reshape(-1).expand(b).contiguous()
    if k_scale is not None and window is None:
        out = ops.mqa_decode(q.reshape(b, h, d), k_cache, v_cache, k_scale, v_scale,
                             lengths, kv_bits=8)
        return out.reshape(b, 1, h, d)
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()
    if v_scale is not None:
        vf = vf * v_scale.float()
    qf = q.reshape(b, hkv, groups, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, kf) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)[None, :]  # [1, S]
    mask = pos < lengths[:, None]
    if window is not None:
        mask = mask & (pos >= (lengths[:, None] - window))
    scores = torch.where(mask[:, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return out.reshape(b, 1, h, d).to(q.dtype)


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


def paged_verify_attention(*args, **kwargs) -> torch.Tensor:
    """Speculative-verify attention: a verify window (the last emitted token
    and the drafts, ``q_lens = n_draft + 1``) is a causal self-chunk, so this
    is :func:`paged_prefill_attention` under the verify entry point
    (kernels/ops.py::paged_mqa_verify states the kernel-level contract)."""
    return paged_prefill_attention(*args, **kwargs)
