"""Plain PyTorch versions of the ported kernels (port of ``repro/kernels/ref.py``).

Each function defines the exact semantics its CUDA kernel must reproduce and
is what the dispatch wrappers in ``ops.py`` run for tensors on the CPU.  They
run on any device, so ``chip_smoke.py`` holds each kernel against its plain
version on the card.

Unlike the JAX oracles, which take *pre-unpacked* int4 pools, these take the
same nibble-packed pools the kernels take (``kv_bits == 4``: two values per
byte along the head dim), so each is a drop-in for its kernel.
"""
from __future__ import annotations

import torch

from repro_torch.quant.pack import unpack_int4

__all__ = [
    "gather_pages",
    "mpmm_ref",
    "paged_mqa_decode_ref",
    "paged_mqa_prefill_ref",
]


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[L, P, ps, ...] paged pool + [B, W] page tables -> [L, B, W*ps, ...]
    contiguous cache rows (tests and benchmarks only; the kernels index the
    pool in place)."""
    g = pool[:, tables.long()]  # [L, B, W, ps, ...]
    l, b, w, ps = g.shape[:4]
    return g.reshape(l, b, w * ps, *g.shape[4:])


def _unpack_w4_k(packed: torch.Tensor) -> torch.Tensor:
    """[K/2, N] K-packed int4 -> [K, N] int8 (byte row r holds K index 2r in
    the low nibble and 2r + 1 in the high nibble)."""
    return unpack_int4(packed, dim=0)


def mpmm_ref(
    x: torch.Tensor,
    w_data: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    w_bits: int,
) -> torch.Tensor:
    """Dequant-mode multi-precision matmul: ``x [M, K]`` times int8 or
    K-packed int4 weights, f32 accumulation, per-column f32 scale applied to
    the f32 sum, one cast to ``x.dtype``.  int -> float conversion of the
    weights is exact (|w| <= 127), so accumulating ``x.float() @ w.float()``
    is the JAX oracle's ``dot_general(x, w.astype(x.dtype),
    preferred_element_type=f32)``."""
    w = _unpack_w4_k(w_data) if w_bits == 4 else w_data
    acc = x.float() @ w.float()
    return (acc * w_scale.float()).to(x.dtype)


def _dequant(payload: torch.Tensor, scale, kv_bits: int) -> torch.Tensor:
    """KV payload -> f32: int4 unpacks along the head dim, int payloads
    multiply by their per-(token, head) scale, bf16 pools just widen."""
    if kv_bits == 4:
        payload = unpack_int4(payload, dim=-1)
    out = payload.float()
    if scale is not None:
        out = out * scale.float()
    return out


def paged_mqa_decode_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale,
    v_scale,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    new_k: torch.Tensor,
    new_v: torch.Tensor,
    new_k_scale=None,
    new_v_scale=None,
    *,
    sm_scale: float,
    kv_bits: int,
    window=None,
) -> torch.Tensor:
    """Single-token GQA attention over a *paged* KV pool plus the step's own
    (not-yet-stored) token.

    q:        [B, H, D]
    k_pool:   [L, P, ps, Hkv, Dk]  int8 payload (nibble-packed for kv4) or float
    k_scale:  [L, P, ps, Hkv, 1]   f32, or None for 16-bit pools
    tables:   [B, W] int32 — page ids, zero-padded past each row's table
    lengths:  [B] int32 — tokens already in the cache; the new token attends
              at position lengths[b], so the softmax spans lengths[b] + 1
              positions (never empty, even at lengths == 0)
    new_k:    [B, Hkv, Dk] payload of this step's token (same dtype as pool)
    returns:  [B, H, D] in q.dtype

    Gather-based on purpose: pages are collected into the contiguous
    [B, W*ps, ...] view, the new token is inserted at its own position, and
    a plain masked softmax runs over it.
    """
    b, h, d = q.shape
    ps, hkv = k_pool.shape[2], k_pool.shape[3]
    w = tables.shape[1]
    s = w * ps
    rows = torch.arange(b, device=q.device)
    lengths = lengths.long()
    tables = tables.long()

    def gather(pool, scale, new, new_scale):
        g = pool[layer][tables]  # [B, W, ps, Hkv, Dk]
        g = g.reshape(b, s, *g.shape[3:])
        sc = None if scale is None else scale[layer][tables].reshape(b, s, hkv, 1)
        g = _dequant(g, sc, kv_bits)
        nf = _dequant(new, new_scale, kv_bits)
        # one spare position so a full table (lengths == W*ps) still has
        # room for this step's token
        g = torch.cat([g, g.new_zeros(b, 1, hkv, d)], dim=1)
        g[rows, lengths] = nf
        return g

    kf = gather(k_pool, k_scale, new_k, new_k_scale)
    vf = gather(v_pool, v_scale, new_v, new_v_scale)
    total = lengths + 1  # cache + this step's token
    qf = q.float().reshape(b, hkv, h // hkv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, kf) * sm_scale
    pos = torch.arange(s + 1, device=q.device)[None, :]
    mask = pos < total[:, None]
    if window is not None:
        mask = mask & (pos >= total[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)


def paged_mqa_prefill_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale,
    v_scale,
    tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    q_lens: torch.Tensor,
    layer: int,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    chunk_k_scale=None,
    chunk_v_scale=None,
    *,
    sm_scale: float,
    kv_bits: int,
    window=None,
) -> torch.Tensor:
    """A C-token query chunk attending to a *paged* KV pool plus the chunk's
    own (not-yet-stored) K/V.

    q:        [B, C, H, D]
    k_pool:   [L, P, ps, Hkv, Dk]  int8 payload (nibble-packed for kv4) or float
    tables:   [B, W] int32 — page ids, zero-padded past each row's table
    ctx_lens: [B] int32 — tokens already materialized; chunk token c sits at
              absolute position ctx_lens[b] + c
    q_lens:   [B] int32 — valid chunk tokens per row (<= C); padding rows
              still attend (their outputs are finite garbage the caller drops)
    chunk_k:  [B, C, Hkv, Dk] payload of this chunk (same dtype as pool)
    returns:  [B, C, H, D] in q.dtype

    Gather-based on purpose: pages are collected into the contiguous
    [B, W*ps, ...] view, the chunk K/V is appended as extra keys at
    positions ctx + j, and one plain masked softmax runs over both.
    """
    b, c, h, d = q.shape
    ps, hkv = k_pool.shape[2], k_pool.shape[3]
    w = tables.shape[1]
    s = w * ps
    dev = q.device
    ctx_lens = ctx_lens.long()
    q_lens = q_lens.long()
    tables = tables.long()

    def gather(pool, scale, new, new_scale):
        g = pool[layer][tables]  # [B, W, ps, Hkv, Dk]
        g = g.reshape(b, s, *g.shape[3:])
        sc = None if scale is None else scale[layer][tables].reshape(b, s, hkv, 1)
        g = _dequant(g, sc, kv_bits)
        nf = _dequant(new, new_scale, kv_bits)
        return torch.cat([g, nf], dim=1)  # [B, S + C, Hkv, D]

    kf = gather(k_pool, k_scale, chunk_k, chunk_k_scale)
    vf = gather(v_pool, v_scale, chunk_v, chunk_v_scale)
    cpos = torch.arange(c, device=dev)
    spos = torch.arange(s, device=dev)
    # absolute position of every key: pool slots then chunk slots
    k_pos = torch.cat(
        [spos.expand(b, s), ctx_lens[:, None] + cpos[None, :]], dim=1
    )  # [B, S + C]
    k_valid = torch.cat(
        [spos[None, :] < ctx_lens[:, None], cpos[None, :] < q_lens[:, None]], dim=1
    )
    q_pos = ctx_lens[:, None] + cpos[None, :]  # [B, C]
    mask = k_valid[:, None, :] & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    qf = q.float().reshape(b, c, hkv, h // hkv, d)
    scores = torch.einsum("bckgd,bskd->bkgcs", qf, kf) * sm_scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)  # fully-masked rows
    out = torch.einsum("bkgcs,bskd->bkgcd", p, vf)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, d).to(q.dtype)
