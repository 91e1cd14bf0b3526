"""Ragged batched decode step straight over the paged KV pool (port of
``repro/serve/decode.py``).

One call decodes one token for every request in a same-precision group.
Each layer calls ``models.attention.paged_decode_attention``, which walks the
group's page tables (the CUDA kernel on the card, its plain version on the
CPU) and reads only the pages holding each row's ``lengths[b]`` cached
tokens; the token being decoded enters the softmax as a fused extra term.
Weight matmuls go through ``models.layers.dense``: the W4/W8 dequant kernel
for quantized weights.

The JAX ``lax.scan`` over layers is a Python loop here, and the pools are
updated *in place*: right after layer ``l``'s attention the rows' new K/V are
scattered into pool layer ``l`` with ``index_put_``.  That equals the JAX
order (attention of every layer, then one scatter) because layer ``l``'s
attention reads only pool layer ``l`` and only positions below each row's
length, and the new token sits at the length.  Rows with ``valid[b] ==
False`` are pow2-bucket padding: JAX drops their scatter through an
out-of-range page id (``mode="drop"``); ``index_put_`` raises on such an
index, so those rows, and any row whose slot falls at or past the table
width W, are masked out of the scatter instead.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as model_lib
from repro_torch.models.layers import apply_rope, dense, rms_norm, torch_dtype


def scatter_rows(pools, layer: int, pages, offs, new_kv) -> None:
    """Write ``new_kv[i][n]`` to ``pools[i][layer, pages[n], offs[n]]`` in
    place for each payload/scale pool (None pools are skipped)."""
    for pool, new in zip(pools, new_kv):
        if pool is not None:
            pool[layer].index_put_((pages, offs), new.to(pool.dtype))


def append_targets(tables, positions, live, page_size: int):
    """Page ids, in-page offsets and the flat row selection for the tokens
    at ``positions`` ([B] or [B, C]) whose ``live`` mask is set and whose
    table slot lies inside the padded width W."""
    w = tables.shape[1]
    slots = positions.long() // page_size
    live = live & (slots < w)
    rows = torch.arange(tables.shape[0], device=tables.device)
    rows = rows.reshape(-1, *([1] * (positions.dim() - 1))).expand_as(slots)
    sel = live.reshape(-1).nonzero().squeeze(1)
    pages = tables.long()[rows.reshape(-1)[sel], slots.reshape(-1)[sel]]
    offs = positions.long().reshape(-1)[sel] % page_size
    return pages, offs, sel


def paged_decode_step(
    params,
    tokens: torch.Tensor,  # [B, 1] int — last generated token per request
    lengths: torch.Tensor,  # [B] int32 — tokens already in cache (new token's position)
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    valid: torch.Tensor,  # [B] bool — False for pow2-bucket padding rows
    pool_k: torch.Tensor,  # [L, P, ps, Hkv, Dk]
    pool_v: torch.Tensor,
    pool_ks,  # [L, P, ps, Hkv, 1] f32 or None (kv_bits == 16)
    pool_vs,
    *,
    cfg: ArchConfig,
):
    """Returns (logits [B, V] f32, pools) where pools = (k, v, k_scale,
    v_scale) are the same tensors, with every valid row's new token written
    into its page.  Append precondition (as in JAX): every valid row has a
    table slot for position lengths[b]."""
    quant = cfg.serve_kv_bits < 16
    bits = cfg.serve_kv_bits
    b = tokens.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_layers, page_size = pool_k.shape[0], pool_k.shape[2]
    pools = (pool_k, pool_v, pool_ks, pool_vs)
    x = params["embed"].to(torch_dtype(cfg.dtype))[tokens.long()]  # [B, 1, D]
    posv = lengths[:, None]  # [B, 1] per-row positions
    pages, offs, sel = append_targets(tables, lengths, valid, page_size)
    windows = model_lib._per_layer_window(cfg, cfg.n_layers)

    for li in range(n_layers):
        p = model_lib.layer_params(params["blocks"], li)
        win = model_lib.layer_window(cfg, windows, li)
        xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
        q = dense(xn, p["wq"]).reshape(b, 1, h, hd)
        k = dense(xn, p["wk"]).reshape(b, 1, hkv, hd)
        v = dense(xn, p["wv"]).reshape(b, 1, hkv, hd)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        if quant:
            kq, ksc = model_lib._quantize_token_kv(k[:, 0], bits)
            vq, vsc = model_lib._quantize_token_kv(v[:, 0], bits)
            o = attn_mod.paged_decode_attention(
                q, pool_k, pool_v, tables, lengths, li, kq, vq,
                window=win, k_scale=pool_ks, v_scale=pool_vs,
                new_k_scale=ksc, new_v_scale=vsc, kv_bits=bits,
            )
            new_kv = (kq, vq, ksc, vsc)
        else:
            kc = k[:, 0].to(pool_k.dtype)
            vc = v[:, 0].to(pool_v.dtype)
            o = attn_mod.paged_decode_attention(
                q, pool_k, pool_v, tables, lengths, li, kc, vc,
                window=win, kv_bits=bits,
            )
            new_kv = (kc, vc, None, None)
        scatter_rows(pools, li, pages, offs, [None if t is None else t[sel] for t in new_kv])
        x = x + dense(o.reshape(b, 1, h * hd), p["wo"])
        x = x + model_lib._mlp_block(p, x, cfg)

    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    logits = dense(x[:, -1], params["unembed"]).float()
    vocab_ok = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return torch.where(vocab_ok, logits, torch.full_like(logits, -1e30)), pools


def paged_decode_sample(
    params, tokens, lengths, tables, valid, samp, pool_k, pool_v, pool_ks, pool_vs,
    *, cfg: ArchConfig,
):
    """One decode step and the next-token choice: each row draws with its
    own (temperature, top_k, top_p) under the position-keyed PRNG
    (``kernels/ops.py::sample_tokens``; greedy rows are the exact argmax).
    ``samp is None`` (an all-greedy group) is the bare argmax.  Returns
    (next_tokens [B] int32, pools)."""
    logits, pools = paged_decode_step(
        params, tokens, lengths, tables, valid, pool_k, pool_v, pool_ks, pool_vs,
        cfg=cfg,
    )
    return ops.sample_or_argmax(logits, samp), pools
