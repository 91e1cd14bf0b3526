"""Shared NN building blocks: norms, RoPE, embeddings, dense / quantized dense.

Port of ``repro/models/layers.py``.  Parameters are plain dicts of tensors;
a quantized weight is a dict ``{"data", "scale", "bits"}`` (int4 payloads
packed along K, per-output-channel f32 scales) consumed by
``kernels.ops.mpmm``: the hand-written dequant kernel on the card, its
plain version on the CPU.  Unquantized weights stay ``torch.matmul``, as the
JAX package leaves that product to XLA; so do the logits of the training
path's ``chunked_cross_entropy``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_mod

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * gamma`` with the variance in f32, the
    rsqrt cast to x.dtype before the products (the JAX order of casts;
    callers cast gamma to x.dtype)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, dtype, *lead: int
) -> torch.Tensor:
    """N(0, 1/d_in) weights [*lead, d_in, d_out] on gen's device, each
    [d_in, d_out] matrix drawn in f32 on its own, so a stack of full-width
    layers never needs an f32 copy of the whole stack.  On the meta device
    (the dry run's shape-only parameters) nothing is drawn."""
    out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for w in out.view(-1, d_in, d_out):
        w.copy_(torch.randn((d_in, d_out), generator=gen, device=gen.device)
                * (1.0 / math.sqrt(d_in)))
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


def dense(x: torch.Tensor, w, split: str | None = None) -> torch.Tensor:
    """Dense matmul dispatching on plain vs quantized weights: quantized
    dicts go through the multi-precision mpmm (f32 accumulate, per-column
    scale in f32, one cast to x.dtype).

    A 16-bit dict runs in int mode, as the reference does: ``x`` truncated
    toward zero to int32, the exact int32 product (mod 2^32), times the f32
    scale, cast to x.dtype.  That is the int mode's plain version, which
    takes any integer x; the card's int kernel takes int8 / int16 x only,
    and a truncated float activation may not fit int16, so on the card a
    16-bit dict raises.

    Under the FSDP/ZeRO-3 mapping the weight passes through
    ``sharding.gather_weight`` first, as in the JAX function.  Under the TP
    mapping ``split`` says how the product splits over ``model``:
    ``"cols"``, this rank's block of N (the input passes
    ``sharding.model_enter``; the output keeps this rank's columns);
    ``"rows"``, this rank's block of K (``x`` is this rank's K block; each
    rank's partial product is kept in f32, a quantized one as the kernel's
    scaled f32 sum, and the partials are summed over ``model`` and cast
    once); None, the whole weight on every model rank."""
    if split is not None and sharding.tp_active():
        if split == "cols":
            return _product(sharding.model_enter(x), sharding.model_block(w, -1))
        if split != "rows":
            raise ValueError(f"split must be 'cols', 'rows' or None, got {split!r}")
        w = sharding.model_block(w, -2)
        if sharding.model_size() == 1 and not isinstance(w, dict):
            return _product(x, w)  # one rank: nothing to sum, the plain product
        # a quantized partial at one rank casts the same f32 sum once: the
        # same bits as the unsplit product
        return sharding.model_reduce(_product(x, w, partial=True)).to(x.dtype)
    return _product(x, sharding.gather_whole(w))


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` ([..., K] x [K, N], one dtype) with an f32 output: a
    row-split partial product.  On the card (and on the dry run's meta
    tensors, whose trace is the card's) one GEMM in the operands' dtype
    writing f32 (``torch.mm(..., out_dtype=)``, which has no backward of
    its own), on the CPU the f32 product of the upcast operands (the same
    sum: bf16 and f16 values are exact in f32).  The backward's incoming
    gradient holds x.dtype values (it comes through the cast of the summed
    partials), so its products run in x.dtype, as the unsplit layer's do."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            out = x2 @ w
        elif x.is_cuda or x.is_meta:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            out = x2.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        gx = (g2 @ w.t()).reshape(x.shape) if ctx.needs_input_grad[0] else None
        gw = x.reshape(-1, x.shape[-1]).t() @ g2 if ctx.needs_input_grad[1] else None
        return gx, gw


def _product(x: torch.Tensor, w, partial: bool = False) -> torch.Tensor:
    """``x @ w`` for a gathered weight; ``partial``: the f32 product (a
    row-split partial sum, summed over ``model`` before the cast)."""
    if isinstance(w, dict):
        bits = int(w["bits"])
        if bits < 16:
            if partial:
                return ops.mpmm(x, w["data"], w["scale"], w_bits=bits,
                                out_dtype=torch.float32)
            return ops.mpmm(x, w["data"], w["scale"], w_bits=bits).to(x.dtype)
        if ops.on_card(x):
            raise ValueError(
                f"16-bit quantized weights run in int mode; the card's int kernel takes "
                f"int8 / int16 activations, got {x.dtype}")
        k, n = x.shape[-1], w["data"].shape[-1]
        acc = ref_mod.mpmm_ref(x.reshape(-1, k).to(torch.int32), w["data"], w["scale"],
                               w_bits=bits, mode="int")
        out = (acc.float() * w["scale"].float()).reshape(*x.shape[:-1], n)
        return out if partial else out.to(x.dtype)
    if partial:
        return _MatmulF32.apply(x, w.to(x.dtype))
    return torch.matmul(x, w.to(x.dtype))


def embed_lookup(embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``embed[tokens]`` in ``dtype``.  Under the TP mapping, where the
    model axis divides the (padded) vocab, each rank looks its tokens up in
    its own block of vocab rows, zeroes the tokens it does not own, and the
    rows are summed over ``model`` (one rank holds each token)."""
    v = sharding.full_shape(embed)[0]
    split = sharding.model_splits(v) and sharding.model_size() > 1
    sharding.log_branch("embed", split, v)
    if not split:
        return sharding.gather_whole(embed)[tokens.long()].to(dtype)
    w = sharding.model_block(embed, 0)
    n = w.shape[0]
    local = tokens.long() - sharding.model_rank() * n
    inside = (local >= 0) & (local < n)
    x = w[local.clamp(0, n - 1)].to(dtype)
    return sharding.model_reduce(torch.where(inside[..., None], x, 0))


_QUANT_COLS = 8192  # columns of one matrix quantized at a time


def quantize_dense_weight(w: torch.Tensor, bits: int, amax_reduce=None) -> dict:
    """Per-output-channel quantization of a [K, N] weight, or of a stack
    [L, ..., K, N] one matrix at a time, each matrix _QUANT_COLS columns at a
    time (columns quantize independently, so the f32 copies ``pack_weights``
    makes are one slab's: the unembedding's whole [K, V] would take three
    f32 copies of it, 4.7 GB at llama3.2-3b's widths).  A meta weight (the
    dry run's shapes) takes the one call: it holds no bytes.
    ``amax_reduce``: ``ops.pack_weights``'s, for a block split along K."""
    if w.is_meta:
        data, scale = ops.pack_weights(w.float(), bits, amax_reduce)
        return {"data": data, "scale": scale, "bits": int(bits)}
    mats = w.reshape(-1, *w.shape[-2:])
    n = w.shape[-1]
    data = scale = None
    for i, m in enumerate(mats):
        for c in range(0, n, _QUANT_COLS):
            d_c, s_c = ops.pack_weights(m[:, c:c + _QUANT_COLS].float(), bits, amax_reduce)
            if data is None:
                data = d_c.new_empty((len(mats), d_c.shape[0], n))
                scale = s_c.new_empty((len(mats), 1, n))
            data[i, :, c:c + d_c.shape[1]] = d_c
            scale[i, :, c:c + s_c.shape[1]] = s_c
    return {"data": data.reshape(*w.shape[:-2], *data.shape[1:]),
            "scale": scale.reshape(*w.shape[:-2], *scale.shape[1:]), "bits": int(bits)}


# ------------------------------------------------------------------ RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D], positions: [B, S] int.  Rotate-half convention (the
    two halves of D, not interleaved pairs), computed in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- chunked cross-entropy ----
def _chunk_nll_sum(hc: torch.Tensor, unembed: torch.Tensor, lc: torch.Tensor,
                   mc: torch.Tensor, vocab) -> torch.Tensor:
    """One chunk's masked NLL sum, its logits in f32 with the pad vocab at
    -1e30."""
    logits = torch.matmul(hc, unembed.to(hc.dtype)).float()
    v = logits.shape[-1]
    if vocab is not None and vocab < v:  # mask embedding-table padding
        pad = torch.arange(v, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    # the label's logit by index: its gradient is an indexed accumulation,
    # where take_along_dim's (a scatter) reads index bounds back to the host
    # under deterministic algorithms, which a captured train step cannot hold
    b, c = lc.shape
    rows = torch.arange(b, device=logits.device)[:, None]
    cols = torch.arange(c, device=logits.device)[None, :]
    gold = logits[rows, cols, lc.long()]
    return torch.sum((logz - gold) * mc)


def _chunk_nll_sum_split(hc: torch.Tensor, unembed: torch.Tensor, lc: torch.Tensor,
                         mc: torch.Tensor, vocab, lo: int) -> torch.Tensor:
    """:func:`_chunk_nll_sum` over this rank's vocab block ``[lo, lo +
    V/M)``: the max and the sum of exps reduced over ``model`` (the max
    without a gradient, the sum by ``model_reduce``), the label's logit
    from the rank that owns it."""
    logits = torch.matmul(hc, unembed.to(hc.dtype)).float()
    v = logits.shape[-1]
    if vocab is not None and vocab < lo + v:
        pad = torch.arange(lo, lo + v, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    mx = sharding.model_all_reduce(logits.detach().amax(dim=-1),
                                   torch.distributed.ReduceOp.MAX)
    sumexp = sharding.model_reduce(torch.exp(logits - mx[..., None]).sum(dim=-1))
    logz = mx + torch.log(sumexp)
    local = lc.long() - lo
    inside = (local >= 0) & (local < v)
    gold = torch.take_along_dim(logits, local.clamp(0, v - 1)[..., None], dim=-1)[..., 0]
    gold = sharding.model_reduce(torch.where(inside, gold, 0.0))
    return torch.sum((logz - gold) * mc)


def chunked_cross_entropy(
    h: torch.Tensor,  # [B, S, D] final hidden states
    unembed: torch.Tensor,  # [D, Vpad] (or this rank's stored block of it)
    labels: torch.Tensor,  # [B, S] int
    mask: torch.Tensor | None = None,  # [B, S]
    vocab: int | None = None,  # real vocab (pad logits masked out)
    max_chunk_elems: int = 1 << 28,
) -> torch.Tensor:
    """Cross-entropy over sequence chunks, so the [tokens, V] logits never
    exist at full length: the JAX function's chunk rule, the masked NLL
    summed chunk by chunk in f32 and divided by max(sum(mask), 1).  Each
    chunk runs under ``torch.utils.checkpoint``, so its logits are
    recomputed in the backward instead of saved: no [tokens, V] tensor is
    kept for the backward either.  The chunk draws no random numbers, so the
    checkpoint keeps no RNG state (reading the card's inside a CUDA graph
    capture would fail).

    On a mesh ``h`` holds this rank's rows of a batch split over the batch
    axes (every axis under the FSDP/ZeRO-3 mapping, ``("pod", "data")``
    under the TP mapping): the chunk count is the JAX function's for the
    global batch and vocab (its budget is per device), the denominator the
    global count of unmasked tokens (an all-reduce over the batch axes), so
    the loss is this rank's share of the global token mean and the batch
    ranks' shares sum to it.  The unembedding is gathered here: whole, or
    under the TP mapping, where the model axis divides the padded vocab,
    this rank's block of vocab columns (``_chunk_nll_sum_split``)."""
    b, s, d = h.shape
    v = sharding.full_shape(unembed)[-1]
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    mesh = sharding.get_mesh()
    n_dev = sharding.mesh_size(mesh) if mesh is not None else 1
    b_all = b * sharding.batch_ranks()
    # budget is per DEVICE: the logits chunk is sharded over the mesh
    n_chunk = max(1, -(-(b_all * s * v) // (max_chunk_elems * n_dev)))
    while n_chunk < s and s % n_chunk:
        n_chunk += 1
    n_chunk = min(n_chunk, s)
    chunk = s // n_chunk
    split = sharding.model_splits(v) and sharding.model_size() > 1
    sharding.log_branch("unembed", split, v)
    if split:
        w = sharding.model_block(unembed, -1)
        h = sharding.model_enter(h)
        fn, extra = _chunk_nll_sum_split, (sharding.model_rank() * w.shape[-1],)
    else:
        w, fn, extra = sharding.gather_whole(unembed), _chunk_nll_sum, ()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(fn, h[:, sl], w, labels[:, sl], mask[:, sl], vocab,
                                   *extra, use_reentrant=False, preserve_rng_state=False)
    count = torch.sum(mask)
    if mesh is not None:
        count = sharding.batch_all_reduce(count.detach().clone())
    return total / torch.clamp_min(count, 1.0)
