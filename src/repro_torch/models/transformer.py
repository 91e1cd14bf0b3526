"""The serving subset of ``repro/models/transformer.py`` for the dense family.

Parameters are plain dicts of tensors with the JAX layout: per-layer
weights stacked along a leading layer dim (``params["blocks"]["wq"]`` is
[L, d_model, H*hd]).  The JAX ``lax.scan`` over layers becomes a Python loop
over layers that takes each layer's slice (:func:`layer_params`).
Initialisation draws from an explicit ``torch.Generator`` on its device; the
numbers differ from ``jax.random`` for the same seed, so parity tests carry
JAX weights over with ``models/convert.py``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    dense,
    dense_init,
    embed_init,
    quantize_dense_weight,
    rms_norm,
    torch_dtype,
)
from repro_torch.quant.pack import pack_int4

Params = dict[str, Any]
_GLOBAL_WINDOW = 1 << 30  # "no window" sentinel (per-layer window lists)
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "in_proj", "out_proj", "unembed"}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random dense-family parameters on ``gen.device``, stacked over layers."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"init_params for the {cfg.family!r} family is not ported yet "
            "(ROADMAP: the other families)"
        )
    dtype = torch_dtype(cfg.dtype)
    dev = gen.device
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    params: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dtype),
        "unembed": dense_init(gen, d, cfg.padded_vocab, dtype),
        "final_norm": torch.ones(d, dtype=torch.float32, device=dev),
    }
    params["blocks"] = {
        "norm1": torch.ones(n, d, dtype=torch.float32, device=dev),
        "wq": dense_init(gen, d, h * hd, dtype, n),
        "wk": dense_init(gen, d, kv * hd, dtype, n),
        "wv": dense_init(gen, d, kv * hd, dtype, n),
        "wo": dense_init(gen, h * hd, d, dtype, n),
        "norm2": torch.ones(n, d, dtype=torch.float32, device=dev),
        "mlp": {
            "wg": dense_init(gen, d, f, dtype, n),
            "wu": dense_init(gen, d, f, dtype, n),
            "wd": dense_init(gen, f, d, dtype, n),
        },
    }
    return params


def quantize_params(params: Params, bits: int) -> Params:
    """The paper's technique on the serving path: every large matmul weight
    becomes an int4/int8 payload + per-output-channel scale (stacked [L, K,
    N] weights quantize layer by layer).  Embeddings stay in the model dtype
    (a gather, not a matmul); norms stay f32."""

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in _QUANT_KEYS and leaf.ndim >= 2:
                out[name] = quantize_dense_weight(leaf, bits)
            else:
                out[name] = leaf
        return out

    return walk(params)


def layer_params(blocks: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked block parameters (views)."""
    out = {}
    for name, leaf in blocks.items():
        if isinstance(leaf, dict) and "bits" in leaf:  # quantized weight
            out[name] = {"data": leaf["data"][li], "scale": leaf["scale"][li],
                         "bits": leaf["bits"]}
        elif isinstance(leaf, dict):
            out[name] = layer_params(leaf, li)
        else:
            out[name] = leaf[li]
    return out


def _mlp_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xn = rms_norm(x, p["norm2"].to(x.dtype), cfg.norm_eps)
    g = dense(xn, p["mlp"]["wg"])
    u = dense(xn, p["mlp"]["wu"])
    act = F.silu(g.float()).to(x.dtype) * u
    return dense(act, p["mlp"]["wd"])


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
