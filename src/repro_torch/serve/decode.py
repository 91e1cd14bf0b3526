"""Ragged batched decode step straight over the paged KV pool (port of
``repro/serve/decode.py``).

One call decodes one token for every request in a same-precision group.
Each layer calls ``models.attention.paged_decode_attention``, which walks the
group's page tables (the CUDA kernel on the card, its plain version on the
CPU) and reads only the pages holding each row's ``lengths[b]`` cached
tokens; the token being decoded enters the softmax as a fused extra term.
Weight matmuls go through ``models.layers.dense``: the W4/W8 dequant kernel
for quantized weights.

Under the tensor-parallel mapping (the engine's ``mesh``: ``sharding.use_mesh``
inside ``sharding.whole_batch()``) a step takes ``transformer.decode_step``'s
splits: where the model axis divides the kv heads, ``wq`` / ``wk`` / ``wv``
column-split and ``wo`` row-split (``transformer._heads``), the paged
kernels on this rank's kv heads and their query heads, whose pools hold
only those heads; the MLP or the experts through ``transformer.ffn_block``;
the embedding and the unembedding split over the vocab, the logits gathered
over ``model`` before the sampler (``transformer.vocab_logits``).  Every
rank computes every row.  With no mapping installed every split is the
whole layer.

The JAX ``lax.scan`` over layers is a Python loop here.  As in JAX, every
layer's attention runs first (it reads only positions below each row's
length, and the new token enters as the fused term), then one scatter
writes the rows' new K/V of every layer into the pools, here *in place*.
Rows with ``valid[b] == False`` are pow2-bucket padding: JAX drops their
scatter through an out-of-range page id (``mode="drop"``).  Here those rows,
and any row whose slot falls at or past the table width W, stay in a
scatter of fixed shape and add nothing (:func:`scatter_rows`), so a step
reads nothing back to the host and can be captured (``serve/graphs.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as model_lib
from repro_torch.models.layers import apply_rope, dense, embed_lookup, rms_norm, torch_dtype


# each pool dtype's integer type of the same width (scatter_rows' bit view)
_BITS = {torch.int8: torch.int8, torch.bfloat16: torch.int16, torch.float16: torch.int16,
         torch.float32: torch.int32}


def scatter_rows(pools, rows, live, new_kv) -> None:
    """Write ``new_kv[i][l, n]`` over row ``rows[n]`` of ``pools[i][l]``,
    seen as ``[P * page_size, ...]``, in place, for every layer l and every
    n with ``live[n]``; a masked n writes nothing (None pools are skipped).
    ``new_kv[i]`` holds every layer's rows, ``[L, N, ...]`` or ``[L, B, C,
    ...]``: one scatter per pool a step, as JAX's one scatter after its
    layer scan.

    The fixed-shape form of JAX's ``mode="drop"`` scatter: every n adds
    ``new - old`` to its row's integer bit pattern, or 0 where masked,
    through ``index_add_``, whose duplicate rows sum (``index_put_``'s have
    no defined winner), so a masked row may share a live row's target.
    Integer addition wraps, so ``old + (new - old)`` is ``new`` bit for bit,
    for int8 payloads, bf16 payloads and f32 scales alike."""
    n_layers, per_layer = pools[0].shape[0], pools[0].shape[1] * pools[0].shape[2]
    layer = torch.arange(n_layers, device=rows.device)[:, None] * per_layer
    idx = (layer + rows[None, :]).reshape(-1)
    mask = live[None, :].expand(n_layers, -1).reshape(-1, 1, 1)
    for pool, new in zip(pools, new_kv):
        if pool is None:
            continue
        bits = _BITS[pool.dtype]
        dst = pool.view(bits).flatten(0, 2)  # [L * P * ps, Hkv, Dk]
        new = new.to(pool.dtype).view(bits).reshape(idx.shape[0], *dst.shape[1:])
        dst.index_add_(0, idx, torch.where(mask, new - dst[idx], 0))


def stack_layers(appended) -> list:
    """Per-layer ``(k, v, k_scale, v_scale)`` tuples -> the four stacked
    along a leading layer dim (None where a pool is absent)."""
    return [None if ts[0] is None else torch.stack(ts) for ts in zip(*appended)]


def append_targets(tables, positions, live, page_size: int):
    """Pool rows (``page * page_size + offset``) of the tokens at
    ``positions`` ([B] or [B, C]), flattened row-major, and the mask of
    those that are written: ``live`` and a table slot inside the padded
    width W.  A masked token gets row 0 and writes nothing through
    :func:`scatter_rows`.  Fixed shapes: nothing is read back."""
    w = tables.shape[1]
    pos = positions.long()
    slots = pos // page_size
    live = live & (slots < w)
    rows = torch.arange(tables.shape[0], device=tables.device)
    rows = rows.reshape(-1, *([1] * (pos.dim() - 1)))
    pages = tables.long()[rows, torch.clamp(slots, max=w - 1)]
    flat = torch.where(live, pages * page_size + pos % page_size, 0)
    return flat.reshape(-1), live.reshape(-1)


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
    h, hkv, cols, rows_split = model_lib._heads(cfg)  # this rank's heads
    hd = cfg.hd
    n_layers, page_size = pool_k.shape[0], pool_k.shape[2]
    pools = (pool_k, pool_v, pool_ks, pool_vs)
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))  # [B, 1, D]
    posv = lengths[:, None]  # [B, 1] per-row positions
    rows, live = append_targets(tables, lengths, valid, page_size)
    windows = model_lib._per_layer_window(cfg, cfg.n_layers)
    appended = []  # each layer's (k, v, k_scale, v_scale), scattered after the loop

    for li in range(n_layers):
        p = model_lib.layer_params(params["blocks"], li)
        win = model_lib.layer_window(cfg, windows, li)
        xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
        q = dense(xn, p["wq"], cols).reshape(b, 1, h, hd)
        k = dense(xn, p["wk"], cols).reshape(b, 1, hkv, hd)
        v = dense(xn, p["wv"], cols).reshape(b, 1, hkv, hd)
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
        appended.append(new_kv)
        x = x + dense(o.reshape(b, 1, h * hd), p["wo"], rows_split)
        x = x + model_lib.ffn_block(p, x, cfg)  # dense MLP or MoE experts

    scatter_rows(pools, rows, live, stack_layers(appended))
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return model_lib.vocab_logits(x[:, -1], params["unembed"], cfg), pools


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
