"""Port of ``repro/models/transformer.py``: parameters and
quantization for every family (dense, moe, ssm, hybrid, and vlm / audio,
whose backbone is the dense stack), the blocks the paged engine uses (dense,
vlm, audio and moe: :func:`ffn_block`), and the contiguous-cache ``prefill``
/ ``decode_step``: the static-wave server runs them (dense, moe, ssm,
hybrid), and the paged engine's one-shot prefill of the vlm and audio archs
runs ``prefill``, whose ``batch["prefix_emb"]`` (``models/frontends.py``)
is prepended to the token embeddings.  An MoE model's leading dense layers
(``first_dense``) are their own stack, ``params["dense_blocks"]``, run before
the MoE ``blocks`` as the JAX functions run their unstacked prefix.

Parameters are plain dicts of tensors with the JAX layout: per-layer
weights stacked along a leading layer dim (``params["blocks"]["wq"]`` is
[L, d_model, H*hd]).  The JAX ``lax.scan`` over layers becomes a Python loop
over layers that takes each layer's slice (:func:`layer_params`).
Initialisation draws from an explicit ``torch.Generator`` on its device; the
numbers differ from ``jax.random`` for the same seed, so parity tests carry
JAX weights over with ``models/convert.py``.

The contiguous cache is a dict like the JAX one, with ``pos`` a 0-d int32
tensor on the cache's device.  Unlike the JAX functions, which return new
arrays, ``prefill`` fills the cache it allocates (or the one it is given)
and ``decode_step`` writes this step's K/V and SSM states into the cache it
is given, in place, and returns that same dict with ``pos`` advanced in
place: at full width a copy of the cache per step would double its memory
and traffic.  ``decode_step`` never reads ``pos`` back to the host, so the
static-wave server can capture it as a CUDA graph (``serve/graphs.py``).

Training: ``forward`` / ``train_loss`` over all four branches (dense, vlm
and audio with per-layer windows; moe with its ``first_dense`` prefix and
the routing aux summed; ssm; hybrid, the shared block once per group, then
the tail), the loss through ``layers.chunked_cross_entropy``.  Each stacked
leaf is split into its layers with one ``unbind`` per forward (a ``leaf[li]``
per layer would make each select's backward write a zero tensor the size of
the whole stack).  Under the FSDP/ZeRO-3 mapping of a mesh step
(``train/trainer.py``) each weight is gathered from this rank's block where
it is used (``sharding.gather_weight`` in ``dense``, the embedding lookup
and the loss), a stacked leaf layer by layer (``sharding.unbind``).
``cfg.remat`` maps JAX's ``jax.checkpoint`` per layer onto
``torch.utils.checkpoint`` (``_maybe_remat``).

Under the TP mapping (``sharding.set_mesh(mesh)``; the mesh train step and
``Server(mesh=)``) each rank runs its rows of the batch, and a layer splits
over ``model`` by the rule of ``sharding.model_splits``: attention over its
kv heads (with their G query heads each; ``wq`` / ``wk`` / ``wv``
column-split, ``wo`` row-split), the MLP over F (``wg`` / ``wu`` columns,
``wd`` rows), the MoE FFN over its experts or else their F
(``models/moe.py``), the embedding and the unembedding over the vocab.  A
layer the model axis does not divide, and every SSM layer (the fused
``in_proj`` columns ``[z, x, B, C, dt]`` have model blocks that do not fall
on head boundaries), gathers its weights whole and runs on every model rank.
The contiguous cache holds this rank's rows and kv heads, and the logits are
gathered over ``model`` before the caller's argmax.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_rope,
    chunked_cross_entropy,
    dense,
    dense_init,
    embed_init,
    embed_lookup,
    quantize_dense_weight,
    rms_norm,
    torch_dtype,
)
from repro_torch.optim import tree
from repro_torch.quant.pack import pack_int4

Params = dict[str, Any]
_GLOBAL_WINDOW = 1 << 30  # "no window" sentinel (per-layer window lists)
_DENSE_STACK = ("dense", "vlm", "audio")  # one stack of dense blocks
_ATTN_STACK = _DENSE_STACK + ("moe",)  # attention in every layer
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "in_proj", "out_proj", "unembed"}


def _init_attn(gen: torch.Generator, cfg: ArchConfig, dtype, *lead: int) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "norm1": torch.ones(*lead, d, dtype=torch.float32, device=gen.device),
        "wq": dense_init(gen, d, h * hd, dtype, *lead),
        "wk": dense_init(gen, d, kv * hd, dtype, *lead),
        "wv": dense_init(gen, d, kv * hd, dtype, *lead),
        "wo": dense_init(gen, h * hd, d, dtype, *lead),
    }


def _init_mlp(gen: torch.Generator, cfg: ArchConfig, dtype, *lead: int) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm2": torch.ones(*lead, d, dtype=torch.float32, device=gen.device),
        "mlp": {
            "wg": dense_init(gen, d, f, dtype, *lead),
            "wu": dense_init(gen, d, f, dtype, *lead),
            "wd": dense_init(gen, f, d, dtype, *lead),
        },
    }


def _init_dense_block(gen: torch.Generator, cfg: ArchConfig, dtype, *lead: int) -> Params:
    return {**_init_attn(gen, cfg, dtype, *lead), **_init_mlp(gen, cfg, dtype, *lead)}


def _init_moe_block(gen: torch.Generator, cfg: ArchConfig, dtype, *lead: int) -> Params:
    p = _init_attn(gen, cfg, dtype, *lead)
    p["norm2"] = torch.ones(*lead, cfg.d_model, dtype=torch.float32, device=gen.device)
    p["moe"] = moe_mod.init_moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                                       *lead)
    return p


def _init_ssm_block(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> Params:
    dims = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_p)
    p = ssm_mod.init_ssm_params(gen, dims, dtype, n)
    p["norm1"] = torch.ones(n, cfg.d_model, dtype=torch.float32, device=gen.device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters on ``gen.device``, stacked over layers: dense
    blocks (dense, vlm, audio); MoE blocks after ``first_dense`` dense ones; SSM blocks; or
    (hybrid) SSM blocks in groups of ``attn_every``, an SSM tail of the
    remainder and one shared attention + MLP block."""
    dtype = torch_dtype(cfg.dtype)
    dev = gen.device
    d = cfg.d_model
    params: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dtype),
        "unembed": dense_init(gen, d, cfg.padded_vocab, dtype),
        "final_norm": torch.ones(d, dtype=torch.float32, device=dev),
    }
    if cfg.family in _DENSE_STACK:
        params["blocks"] = _init_dense_block(gen, cfg, dtype, cfg.n_layers)
    elif cfg.family == "moe":
        if cfg.first_dense:
            params["dense_blocks"] = _init_dense_block(gen, cfg, dtype, cfg.first_dense)
        params["blocks"] = _init_moe_block(gen, cfg, dtype, cfg.n_layers - cfg.first_dense)
    elif cfg.family == "ssm":
        params["blocks"] = _init_ssm_block(gen, cfg, dtype, cfg.n_layers)
    elif cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        params["blocks"] = _init_ssm_block(gen, cfg, dtype, n_groups * cfg.attn_every)
        if rem:
            params["tail"] = _init_ssm_block(gen, cfg, dtype, rem)
        params["shared"] = _init_dense_block(gen, cfg, dtype)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return params


def quantize_params(params: Params, bits: int, mesh=None) -> Params:
    """The paper's technique on the serving path: every large matmul weight
    becomes an int4/int8 payload + per-output-channel scale (stacked [L, K,
    N] weights quantize layer by layer, MoE experts [L, E, K, N] expert by
    expert, as the JAX ``vmap`` does).  Embeddings stay in the model dtype
    (a gather, not a matmul); norms and the MoE router stay f32.

    With ``mesh``, ``params`` are this rank's blocks (``reshard_state``),
    and each block quantizes on its own: its column maxima reduced over the
    axes that split K (:func:`_quantize_block`), so the payload and scales
    are this rank's blocks of the whole weight's, bit for bit."""

    def walk(tree, prefix):
        out = {}
        for name, leaf in tree.items():
            path = f"{prefix}/{name}" if prefix else name
            if isinstance(leaf, dict):
                out[name] = walk(leaf, path)
            elif name in _QUANT_KEYS and leaf.ndim >= 2:
                out[name] = (quantize_dense_weight(leaf, bits) if mesh is None
                             else _quantize_block(path, leaf, bits, mesh))
            else:
                out[name] = leaf
        return out

    return walk(params, "")


def _quantize_block(path: str, block: torch.Tensor, bits: int, mesh) -> dict:
    """This rank's block (a ``reshard_state`` leaf at ``path``) quantized as
    its piece of the whole weight: the scale of a column is the whole
    column's, and the payload and scale are the blocks the sharding rules
    give the quantized leaf, which must be the block's own (an int4 payload
    halves K, which the axes that split K must still divide)."""
    s = block._mesh_sharding
    q = quantize_dense_weight(block, bits,
                              lambda amax: sharding.dim_all_max(amax, s, -2, block.ndim))
    full = s.global_shape(tuple(block.shape))
    for key in ("data", "scale"):
        shape = list(full)
        shape[-2] = 1 if key == "scale" else (full[-2] // 2 if bits == 4 else full[-2])
        want = sharding.leaf_sharding(f"{path}/{key}", shape, mesh)
        if tuple(q[key].shape) != tuple(sl.stop - sl.start for sl in want.index(shape)):
            raise ValueError(f"{path}: the rules split the w{bits} {key} {shape} as "
                             f"{want.spec}, not as the block's {s.spec}")
        q[key]._mesh_sharding = want
    return q


def layer_params(blocks: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked block parameters (views; a
    block of a mesh keeps its sharding, ``sharding.take``)."""
    out = {}
    for name, leaf in blocks.items():
        if isinstance(leaf, dict) and "bits" in leaf:  # quantized weight
            out[name] = {"data": sharding.take(leaf["data"], li),
                         "scale": sharding.take(leaf["scale"], li), "bits": leaf["bits"]}
        elif isinstance(leaf, dict):
            out[name] = layer_params(leaf, li)
        else:
            out[name] = sharding.take(leaf, li)
    return out


def _split(kind: str, n: int) -> tuple[Optional[str], Optional[str]]:
    """(column, row) ``dense`` splits of a layer whose model-parallel dim
    has size ``n`` (``sharding.model_splits``), logged once per kind."""
    split = sharding.model_splits(n)
    sharding.log_branch(kind, split, n)
    return ("cols", "rows") if split else (None, None)


def _mlp_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xn = rms_norm(x, p["norm2"].to(x.dtype), cfg.norm_eps)
    cols, rows = _split("mlp", cfg.d_ff)
    g = dense(xn, p["mlp"]["wg"], cols)
    u = dense(xn, p["mlp"]["wu"], cols)
    act = F.silu(g.float()).to(x.dtype) * u
    return dense(act, p["mlp"]["wd"], rows)


def _moe_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    xn = rms_norm(x, p["norm2"].to(x.dtype), cfg.norm_eps)
    return moe_mod.moe_ffn(xn, p["moe"], top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, dispatch=cfg.moe_dispatch)


def ffn_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A layer's FFN residual term: its experts where it has them (an MoE
    block; the auxiliary loss is dropped, as serving drops it), else its
    dense MLP."""
    if "moe" in p:
        return _moe_block(p, x, cfg)[0]
    return _mlp_block(p, x, cfg)


def _per_layer_window(cfg: ArchConfig, n: int) -> Optional[list[int]]:
    """Per-layer window list (gemma3-style local:global patterns), or None
    if uniform."""
    if cfg.local_ratio:
        period = cfg.local_ratio + 1
        return [_GLOBAL_WINDOW if (i + 1) % period == 0 else cfg.window for i in range(n)]
    return None


def layer_window(cfg: ArchConfig, windows: Optional[list[int]], li: int):
    """Window of layer ``li``: the per-layer list entry, else cfg.window."""
    if windows is not None:
        return windows[li]
    return cfg.window if cfg.window else None


def _quantize_token_kv(kv: torch.Tensor, bits: int):
    """[..., hd] -> (int8 payload, f32 scale[..., 1]) per (token, head).
    bits == 4 bit-packs nibble pairs along hd, so the payload trailing dim is
    hd//2 (the int4 page-pool layout)."""
    kf = kv.float()
    amax = torch.clamp_min(kf.abs().amax(dim=-1, keepdim=True), 1e-30)
    qmax = float(2 ** (bits - 1) - 1)
    scale = amax / qmax
    q = torch.clamp(torch.round(kf / scale), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        q = pack_int4(q, dim=-1)
    return q, scale.float()


# ================================================= contiguous-cache serving ====
# The static-wave path (train/server.py): prefill the whole (left-padded)
# prompt, then one decode step per token with one position shared by the
# batch; and the engine's one-shot prefill of the vlm and audio archs.


def _heads(cfg: ArchConfig) -> tuple[int, int, Optional[str], Optional[str]]:
    """(query heads, kv heads) this rank computes and the (column, row)
    splits of its attention: under the TP mapping, where the model axis
    divides the kv heads, its block of them and their G query heads each
    (query head h uses kv head h // G), else all of them."""
    cols, rows = _split("attention", cfg.n_kv_heads)
    m = sharding.model_size() if cols else 1
    return cfg.n_heads // m, cfg.n_kv_heads // m, cols, rows


def _attn_block(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                window) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out [B,S,D], k, v); k/v exposed for cache building."""
    b, s, _ = x.shape
    h, kv, cols, rows = _heads(cfg)
    hd = cfg.hd
    xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
    q = dense(xn, p["wq"], cols).reshape(b, s, h, hd)
    k = dense(xn, p["wk"], cols).reshape(b, s, kv, hd)
    v = dense(xn, p["wv"], cols).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn_mod.flash_attention(q, k, v, causal=True, window=window)
    return dense(o.reshape(b, s, h * hd), p["wo"], rows), k, v


def _embed(params: Params, batch: dict, cfg: ArchConfig):
    """Returns (x [B,S,D], positions [B,S], loss mask [B,S] f32); with a
    frontend, the [B, P, D] ``batch["prefix_emb"]`` comes first, positions
    run over P + S and the mask is 0 over the prefix, 1 over the tokens."""
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    if cfg.prefix_len:
        pre = batch["prefix_emb"].to(x.dtype)
        x = torch.cat([pre, x], dim=1)
        mask = torch.cat([mask.new_zeros(pre.shape[:2]), mask], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, mask


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, device=None) -> Params:
    """Pre-allocated decode cache.  KV payloads are int8 when
    cfg.serve_kv_bits < 16 (nibble-packed along the head dim at 4 bits),
    in the model dtype otherwise; SSM states are f32.  Under the TP mapping
    ``batch_size`` is this rank's rows, and the kv heads are its own where
    the attention splits (``_heads``)."""
    kv, hd = _heads(cfg)[1], cfg.hd
    quant = cfg.serve_kv_bits < 16
    if cfg.serve_kv_bits == 4:
        hd = hd // 2
    kv_dtype = torch.int8 if quant else torch_dtype(cfg.dtype)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    n_attn = cfg.n_layers if cfg.family in _ATTN_STACK else 0
    if not n_attn:
        dims = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_p)
        state = (batch_size, dims.n_heads, dims.head_p, dims.state)
        if cfg.family == "ssm":
            cache["ssm"] = zeros(cfg.n_layers, *state)
        else:
            n_groups, rem = divmod(cfg.n_layers, cfg.attn_every)
            cache["ssm"] = zeros(n_groups * cfg.attn_every, *state)
            if rem:
                cache["ssm_tail"] = zeros(rem, *state)
            n_attn = n_groups
    if n_attn:
        cache["k"] = zeros(n_attn, batch_size, max_len, kv, hd, dtype=kv_dtype)
        cache["v"] = torch.zeros_like(cache["k"])
        if quant:
            cache["k_scale"] = zeros(n_attn, batch_size, max_len, kv, 1)
            cache["v_scale"] = torch.zeros_like(cache["k_scale"])
    return cache


def _write_cache_slab(cache_k: torch.Tensor, kq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write [B, S_new, ...] at sequence offset ``pos`` (a 0-d tensor on the
    cache's device) into [B, S_max, ...], in place; the offset clamps so the
    slab fits, as JAX's ``dynamic_update_slice`` does."""
    n = kq.shape[1]
    start = torch.clamp(pos.long(), 0, cache_k.shape[1] - n)
    idx = start + torch.arange(n, device=cache_k.device)
    return cache_k.index_copy_(1, idx, kq.to(cache_k.dtype))


def _attn_stack(params: Params) -> list[Params]:
    """Each layer's parameters of an attention stack (dense or moe), in
    cache order: an MoE model's ``first_dense`` dense layers, then its
    blocks."""
    stacks = [params[k] for k in ("dense_blocks", "blocks") if k in params]
    return [layer_params(st, li) for st in stacks for li in range(st["norm1"].shape[0])]


def _log_ssm(dims) -> None:
    sharding.log_branch("ssm", False, dims.n_heads,
                        "the fused in_proj's model blocks do not fall on head boundaries")


def _ssm_layer(p: Params, x: torch.Tensor, cfg: ArchConfig, dims, state=None):
    """Pre-norm residual SSM layer: prefill (state None) returns (x, final
    state); decode steps ``state`` once and returns (x, new state)."""
    _log_ssm(dims)
    xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
    if state is None:
        y, st = ssm_mod.ssm_block_with_state(p, xn, dims)
    else:
        y, st = ssm_mod.ssm_decode_step(p, xn, state, dims)
    return x + y, st


def vocab_logits(x: torch.Tensor, unembed, cfg: ArchConfig) -> torch.Tensor:
    """f32 logits of hidden states ``x`` [..., D], the padded vocab masked
    to -1e30; under the TP mapping, where the model axis divides the padded
    vocab, each rank's vocab columns gathered over ``model``, so every rank
    samples from the same logits."""
    cols, _ = _split("unembed", cfg.padded_vocab)
    logits = sharding.model_all_gather(dense(x, unembed, cols).float())
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    return logits.masked_fill(pad, -1e30)


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Last position's f32 logits (:func:`vocab_logits`)."""
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return vocab_logits(x[:, -1], params["unembed"], cfg)


def prefill(params: Params, batch: dict, cfg: ArchConfig, max_len: int,
            cache: Optional[Params] = None):
    """Processes the full prompt ``batch["tokens"] [B, S]`` (after
    ``batch["prefix_emb"]`` where the arch has a frontend); returns
    (last-token logits [B, V] f32, cache).  ``cache``, an ``init_cache(cfg,
    B, max_len)`` dict, is zeroed and filled in place instead of a new one:
    a captured decode step reads its buffers by address."""
    x, positions, _ = _embed(params, batch, cfg)
    b, s, _ = x.shape
    quant = cfg.serve_kv_bits < 16
    if cache is None:
        cache = init_cache(cfg, b, max_len, x.device)
    else:
        for buf in cache.values():
            buf.zero_()

    def fill_kv(slot: int, k: torch.Tensor, v: torch.Tensor) -> None:
        if quant:
            k, ks = _quantize_token_kv(k, cfg.serve_kv_bits)
            v, vs = _quantize_token_kv(v, cfg.serve_kv_bits)
            cache["k_scale"][slot, :, :s] = ks
            cache["v_scale"][slot, :, :s] = vs
        cache["k"][slot, :, :s] = k
        cache["v"][slot, :, :s] = v

    if cfg.family in _ATTN_STACK:
        windows = _per_layer_window(cfg, cfg.n_layers)
        for li, p in enumerate(_attn_stack(params)):
            a, k, v = _attn_block(p, x, positions, cfg, layer_window(cfg, windows, li))
            x = x + a
            x = x + ffn_block(p, x, cfg)
            fill_kv(li, k, v)
    else:
        dims = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_p)
        every = cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
        n_blocks = cache["ssm"].shape[0]
        for li in range(n_blocks):
            x, cache["ssm"][li] = _ssm_layer(layer_params(params["blocks"], li), x, cfg, dims)
            if cfg.family == "hybrid" and (li + 1) % every == 0:
                shared = params["shared"]
                a, k, v = _attn_block(shared, x, positions, cfg, cfg.window)
                x = x + a
                x = x + _mlp_block(shared, x, cfg)
                fill_kv(li // every, k, v)
        for li in range(cache["ssm_tail"].shape[0] if "ssm_tail" in cache else 0):
            x, cache["ssm_tail"][li] = _ssm_layer(layer_params(params["tail"], li), x, cfg,
                                                  dims)
    cache["pos"].fill_(s)
    return _logits(params, x, cfg), cache


def _decode_attn(p: Params, x: torch.Tensor, cache_slice: dict, pos: torch.Tensor,
                 cfg: ArchConfig, window):
    """One-layer decode attention: x [B,1,D] + this layer's cache slice
    (views, written in place) at the 0-d device position ``pos`` -> (out
    [B,1,D], the slice)."""
    if cfg.serve_kv_bits == 4:
        raise NotImplementedError(
            "int4 KV payloads are nibble-packed; only the paged serve path "
            "(serve/decode.py) unpacks them — use ServeEngine, not decode_step"
        )
    b = x.shape[0]
    h, kv, cols, rows = _heads(cfg)
    hd = cfg.hd
    xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
    q = dense(xn, p["wq"], cols).reshape(b, 1, h, hd)
    k = dense(xn, p["wk"], cols).reshape(b, 1, kv, hd)
    v = dense(xn, p["wv"], cols).reshape(b, 1, kv, hd)
    posv = pos.long().reshape(1, 1).expand(b, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    ck, cv = cache_slice["k"], cache_slice["v"]
    if cfg.serve_kv_bits < 16:
        kq, ksc = _quantize_token_kv(k, cfg.serve_kv_bits)
        vq, vsc = _quantize_token_kv(v, cfg.serve_kv_bits)
        _write_cache_slab(ck, kq, pos)
        _write_cache_slab(cv, vq, pos)
        _write_cache_slab(cache_slice["k_scale"], ksc, pos)
        _write_cache_slab(cache_slice["v_scale"], vsc, pos)
        o = attn_mod.decode_attention(q, ck, cv, pos + 1, window=window,
                                      k_scale=cache_slice["k_scale"],
                                      v_scale=cache_slice["v_scale"])
    else:
        _write_cache_slab(ck, k, pos)
        _write_cache_slab(cv, v, pos)
        o = attn_mod.decode_attention(q, ck, cv, pos + 1, window=window)
    return dense(o.reshape(b, 1, h * hd), p["wo"], rows), cache_slice


def _cache_slice(cache: Params, i: int) -> dict:
    return {k: cache[k][i] for k in ("k", "v", "k_scale", "v_scale") if k in cache}


def decode_step(params: Params, tokens: torch.Tensor, cache: Params, cfg: ArchConfig):
    """One decode step: tokens [B, 1] -> (logits [B, V] f32, cache), the
    cache updated in place (see the module note)."""
    pos = cache["pos"]
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))  # [B, 1, D]

    if cfg.family in _ATTN_STACK:
        windows = _per_layer_window(cfg, cfg.n_layers)
        for li, p in enumerate(_attn_stack(params)):
            a, _ = _decode_attn(p, x, _cache_slice(cache, li), pos, cfg,
                                layer_window(cfg, windows, li))
            x = x + a
            x = x + ffn_block(p, x, cfg)
    else:
        dims = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_p)
        every = cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
        for li in range(cache["ssm"].shape[0]):
            x, cache["ssm"][li] = _ssm_layer(layer_params(params["blocks"], li), x, cfg,
                                             dims, cache["ssm"][li])
            if cfg.family == "hybrid" and (li + 1) % every == 0:
                shared = params["shared"]
                a, _ = _decode_attn(shared, x, _cache_slice(cache, li // every), pos, cfg,
                                    cfg.window)
                x = x + a
                x = x + _mlp_block(shared, x, cfg)
        for li in range(cache["ssm_tail"].shape[0] if "ssm_tail" in cache else 0):
            x, cache["ssm_tail"][li] = _ssm_layer(layer_params(params["tail"], li), x, cfg,
                                                  dims, cache["ssm_tail"][li])
    pos.add_(1)
    return _logits(params, x, cfg), cache


# ============================================================== training ====
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots``: keep matmul outputs, recompute the rest."""
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` as ``cfg.remat`` asks: "none" as is; "full" recomputed in the
    backward (non-reentrant ``torch.utils.checkpoint``); "dots" the same,
    but the matmul outputs saved (a selective-checkpoint policy).  The
    training forward draws no random numbers, so no RNG state is kept for
    the recompute (the card's cannot be read inside a captured train step)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=context,
                                 preserve_rng_state=False)
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _unstack(blocks: Params) -> list[Params]:
    """Each layer's parameters of a stacked block tree, every leaf split by
    one ``unbind`` (see the module note)."""
    parts = [sharding.unbind(leaf) for leaf in tree.leaves(blocks)]
    return [tree.unflatten(blocks, [p[li] for p in parts]) for li in range(len(parts[0]))]


def forward(params: Params, batch: dict, cfg: ArchConfig):
    """Full forward pass -> (hidden [B,S,D], aux loss 0-d f32, positions,
    loss mask)."""
    x, positions, mask = _embed(params, batch, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def dense_layer(x, p, window):
        a, _, _ = _attn_block(p, x, positions, cfg, window)
        x = x + a
        return x + _mlp_block(p, x, cfg)

    if cfg.family in _DENSE_STACK:
        windows = _per_layer_window(cfg, cfg.n_layers)
        layer = _maybe_remat(dense_layer, cfg)
        for li, p in enumerate(_unstack(params["blocks"])):
            x = layer(x, p, layer_window(cfg, windows, li))

    elif cfg.family == "moe":
        def moe_layer(x, p):
            a, _, _ = _attn_block(p, x, positions, cfg, cfg.window)
            x = x + a
            m, aux_l = _moe_block(p, x, cfg)
            return x + m, aux_l

        if cfg.first_dense:
            layer = _maybe_remat(dense_layer, cfg)
            for p in _unstack(params["dense_blocks"]):
                x = layer(x, p, cfg.window)
        layer = _maybe_remat(moe_layer, cfg)
        for p in _unstack(params["blocks"]):
            x, aux_l = layer(x, p)
            aux_total = aux_total + aux_l

    elif cfg.family in ("ssm", "hybrid"):
        dims = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_p)

        def ssm_layer(x, p):
            _log_ssm(dims)
            xn = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
            return x + ssm_mod.ssm_block(p, xn, dims)

        layers = _unstack(params["blocks"])
        if cfg.family == "ssm":
            layer = _maybe_remat(ssm_layer, cfg)
            for p in layers:
                x = layer(x, p)
        else:
            every, shared = cfg.attn_every, params["shared"]

            def group(x, ps):
                for p in ps:
                    x = ssm_layer(x, p)
                return dense_layer(x, shared, cfg.window)

            layer = _maybe_remat(group, cfg)
            for g0 in range(0, len(layers), every):
                x = layer(x, layers[g0:g0 + every])
            for p in _unstack(params["tail"]) if "tail" in params else []:
                x = ssm_layer(x, p)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")

    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x, aux_total, positions, mask


def train_loss(params: Params, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """(loss, {"ce", "aux"}): the masked next-token cross-entropy plus 0.01
    x the MoE routing aux; prefix positions carry no labels.  On a mesh the
    ce is this rank's share of the global token mean and the aux the global
    batch's (the same on every rank), so the loss is the share ce + 0.01 x
    aux / (batch ranks): the batch ranks' losses sum to the global loss."""
    h, aux, _, mask = forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.prefix_len:
        labels = torch.cat([labels.new_zeros(labels.shape[0], cfg.prefix_len), labels], dim=1)
    ce = chunked_cross_entropy(h, params["unembed"], labels, mask, vocab=cfg.vocab)
    n_b = sharding.batch_ranks()
    loss = ce + 0.01 * (aux if n_b == 1 else aux / n_b)
    return loss, {"ce": ce, "aux": aux}
