"""Chunked-prefill step straight over the paged KV pool (port of
``repro/serve/prefill.py``).

One call advances a same-precision group of requests through one chunk of
their uncached prompt suffix.  Chunk token ``i`` of row ``b`` sits at
position ``q_start[b] + i``; attention reads the pages holding each row's
``q_start[b]`` materialized tokens (the prefix-cache hit plus earlier
chunks) through the page tables, and the chunk attends to itself causally as
a fused term.  ``q_lens[b] <= C`` masks bucket padding.  Returns per-row
logits at each row's *last valid* chunk position, so the call that
completes a prompt yields the request's first output token.

As in ``serve/decode.py`` the layer scan is a Python loop and each layer's
chunk K/V goes into its pool layer in place right after that layer's
attention; padding positions and slots at or past the table width are
masked out of the ``index_put_`` (JAX drops them with ``mode="drop"``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as model_lib
from repro_torch.models.layers import apply_rope, dense, rms_norm, torch_dtype
from repro_torch.serve.decode import append_targets, scatter_rows


def bucket_pow2(n: int) -> int:
    """Smallest power of two >= n (shape bucketing)."""
    return 1 << max(n - 1, 0).bit_length()


def chunk_forward(
    params,
    tokens: torch.Tensor,  # [B, C] int — this chunk's tokens (tail-padded)
    q_start: torch.Tensor,  # [B] int32 — tokens already materialized per row
    q_lens: torch.Tensor,  # [B] int32 — valid tokens of this chunk (<= C)
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    pool_k: torch.Tensor,  # [L, P, ps, Hkv, Dk]
    pool_v: torch.Tensor,
    pool_ks,  # [L, P, ps, Hkv, 1] f32 or None (kv_bits == 16)
    pool_vs,
    *,
    cfg: ArchConfig,
):
    """Run one causal self-chunk through the model: returns (final-normed
    hidden states [B, C, D], pools) with the chunk's K/V written into its
    pages.  Preconditions: every row's table covers positions
    ``[0, q_start + q_len)`` and positions ``[0, q_start)`` are already in
    the pool."""
    quant = cfg.serve_kv_bits < 16
    bits = cfg.serve_kv_bits
    b, c = tokens.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_layers, page_size = pool_k.shape[0], pool_k.shape[2]
    pools = (pool_k, pool_v, pool_ks, pool_vs)
    x = params["embed"].to(torch_dtype(cfg.dtype))[tokens.long()]  # [B, C, D]
    cpos = torch.arange(c, device=tokens.device, dtype=torch.int32)
    posv = q_start[:, None] + cpos[None, :]  # [B, C] absolute positions
    live = cpos[None, :] < q_lens[:, None]
    pages, offs, sel = append_targets(tables, posv, live, page_size)
    windows = model_lib._per_layer_window(cfg, cfg.n_layers)

    for li in range(n_layers):
        p = model_lib.layer_params(params["blocks"], li)
        win = model_lib.layer_window(cfg, windows, li)
        xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
        q = dense(xn, p["wq"]).reshape(b, c, h, hd)
        k = dense(xn, p["wk"]).reshape(b, c, hkv, hd)
        v = dense(xn, p["wv"]).reshape(b, c, hkv, hd)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        if quant:
            kq, ksc = model_lib._quantize_token_kv(k, bits)
            vq, vsc = model_lib._quantize_token_kv(v, bits)
            o = attn_mod.paged_prefill_attention(
                q, pool_k, pool_v, tables, q_start, q_lens, li, kq, vq,
                window=win, k_scale=pool_ks, v_scale=pool_vs,
                chunk_k_scale=ksc, chunk_v_scale=vsc, kv_bits=bits,
            )
            new_kv = (kq, vq, ksc, vsc)
        else:
            kc = k.to(pool_k.dtype)
            vc = v.to(pool_v.dtype)
            o = attn_mod.paged_prefill_attention(
                q, pool_k, pool_v, tables, q_start, q_lens, li, kc, vc,
                window=win, kv_bits=bits,
            )
            new_kv = (kc, vc, None, None)
        flat = [None if t is None else t.reshape(b * c, *t.shape[2:])[sel] for t in new_kv]
        scatter_rows(pools, li, pages, offs, flat)
        x = x + dense(o.reshape(b, c, h * hd), p["wo"])
        x = x + model_lib._mlp_block(p, x, cfg)

    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x, pools


def chunk_prefill_step(
    params, tokens, q_start, q_lens, tables, pool_k, pool_v, pool_ks, pool_vs,
    *, cfg: ArchConfig,
):
    """Returns (logits [B, V] f32 at each row's last valid chunk position,
    pools); see :func:`chunk_forward` for the contract."""
    x, pools = chunk_forward(
        params, tokens, q_start, q_lens, tables, pool_k, pool_v, pool_ks, pool_vs,
        cfg=cfg,
    )
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, torch.clamp(q_lens.long() - 1, min=0)]  # [B, D]
    logits = dense(last, params["unembed"]).float()
    vocab_ok = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return torch.where(vocab_ok, logits, torch.full_like(logits, -1e30)), pools


def chunk_prefill_sample(
    params, tokens, q_start, q_lens, tables, samp, pool_k, pool_v, pool_ks, pool_vs,
    *, cfg: ArchConfig,
):
    """One prefill chunk and the first-token choice.  ``samp is None`` (an
    all-greedy group) is the bare argmax, the only case this slice ports.
    Returns (first_tokens [B] int32, pools)."""
    if samp is not None:
        raise NotImplementedError(
            "sampled decoding (threefry-parity sampling) is not ported yet "
            "(ROADMAP: sampling)"
        )
    logits, pools = chunk_prefill_step(
        params, tokens, q_start, q_lens, tables, pool_k, pool_v, pool_ks, pool_vs,
        cfg=cfg,
    )
    return torch.argmax(logits, dim=-1).to(torch.int32), pools
