"""Plain PyTorch versions of the ported kernels (port of ``repro/kernels/ref.py``).

Each function defines the exact semantics its CUDA kernel must reproduce and
is what the dispatch wrappers in ``ops.py`` run for tensors on the CPU.  They
run on any device, so ``chip_smoke.py`` holds each kernel against its plain
version on the card.

Unlike the JAX oracles, which take *pre-unpacked* int4 pools, the paged
versions take the same nibble-packed pools the kernels take (``kv_bits ==
4``: two values per byte along the head dim), so each is a drop-in for its
kernel.  ``mqa_decode_ref`` is the JAX oracle's copy and takes unpacked int8
K/V; ``ops.mqa_decode`` unpacks int4 before calling it.
"""
from __future__ import annotations

import torch

from repro_torch.quant.pack import unpack_int4

__all__ = [
    "FF_STAGE_K",
    "gather_pages",
    "mpmm_ref",
    "mpmm_ff_ref",
    "conv_patches",
    "mpconv_ref",
    "mqa_decode_ref",
    "paged_mqa_decode_ref",
    "paged_mqa_prefill_ref",
]


FF_STAGE_K = 512  # K rows per FF-order stage: the JAX kernel's bk


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
    mode: str = "dequant",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Multi-precision matmul ``x [M, K]`` times int8/int16 or K-packed int4
    weights.

    int mode: exact int32 ``x @ w`` with wraparound mod 2^32 (the 32-bit SAU
    accumulators), unscaled: the wrapper scales.  torch's int32 matmul wraps
    on the CPU; CUDA has none, so this mode runs on CPU tensors.

    dequant mode: f32 accumulation, per-column f32 scale applied to the f32
    sum, one cast to ``out_dtype`` (default ``x.dtype``; f32 leaves the
    scaled sum uncast).  int -> float conversion of the weights is
    exact (|w| <= 127), so accumulating ``x.float() @ w.float()`` is the JAX
    oracle's ``dot_general(x, w.astype(x.dtype), preferred_element_type=f32)``.
    """
    w = _unpack_w4_k(w_data) if w_bits == 4 else w_data
    if mode == "int":
        return x.to(torch.int32) @ w.to(torch.int32)
    acc = x.float() @ w.float()
    return (acc * w_scale.float()).to(out_dtype or x.dtype)


def mpmm_ff_ref(
    x: torch.Tensor, w_data: torch.Tensor, *, w_bits: int, stage_k: int = FF_STAGE_K
) -> torch.Tensor:
    """Dequant matmul in the FF order: k outermost.  Each K stage of
    ``stage_k`` rows (the JAX kernel's ``bk``) is an f32 product of its own,
    added in stage order to an f32 ``[M, N]`` accumulator: the partial sums
    that spill between stages.  Returns that accumulator unscaled, as the
    kernel does; the wrapper applies the scale in f32 and casts."""
    w = (_unpack_w4_k(w_data) if w_bits == 4 else w_data).float()
    xf = x.float()
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
    for k0 in range(0, x.shape[1], stage_k):
        acc = acc + xf[:, k0:k0 + stage_k] @ w[k0:k0 + stage_k]
    return acc


def conv_patches(x: torch.Tensor, ksize: int, stride: int, padding: int) -> torch.Tensor:
    """``[N, H, W, C]`` -> ``[N, Ho, Wo, C*ksize*ksize]`` patches with the
    feature order (c, kh, kw) of ``lax.conv_general_dilated_patches`` (and of
    ``F.unfold``).  Strided slices of the zero-padded input, so any dtype
    works, int16 included (``F.unfold`` refuses integers on the CPU)."""
    if padding:
        x = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    n, h, w, c = x.shape
    ho = (h - ksize) // stride + 1
    wo = (w - ksize) // stride + 1
    taps = [
        x[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
        for i in range(ksize)
        for j in range(ksize)
    ]
    return torch.stack(taps, dim=-1).reshape(n, ho, wo, c * ksize * ksize)


def mpconv_ref(
    x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 0
) -> torch.Tensor:
    """NHWC x HWIO convolution oracle: exact int32 (wraparound) for integer
    ``x``, else f32 accumulation of ``x`` against ``w`` cast to ``x.dtype``,
    cast back to ``x.dtype``."""
    kh, kw, cin, cout = w.shape
    if not x.dtype.is_floating_point:
        patches = conv_patches(x, kh, stride, padding)
        wm = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
        n, ho, wo, f = patches.shape
        out = patches.reshape(-1, f).to(torch.int32) @ wm.to(torch.int32)
        return out.reshape(n, ho, wo, cout)
    out = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).float(),
        w.to(x.dtype).float().permute(3, 2, 0, 1),
        stride=stride,
        padding=padding,
    )
    return out.permute(0, 2, 3, 1).to(x.dtype)


def mqa_decode_ref(
    q: torch.Tensor,
    k_data: torch.Tensor,
    v_data: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Single-token GQA attention over a quantized contiguous KV cache (the
    plain version of csrc/mqa_decode.cu).

    q:        [B, H, D]            (bf16/f32)
    k_data:   [B, S, Hkv, D] int8  (quantized keys, unpacked)
    v_data:   [B, S, Hkv, D] int8
    k_scale:  [B, S, Hkv, 1] f32   (per-token-per-head scales)
    v_scale:  [B, S, Hkv, 1] f32
    lengths:  [B] int32 — valid cache length per sequence (masking)
    returns:  [B, H, D] in q.dtype

    A row of length 0 gives NaN here (a softmax over nothing), as in the JAX
    oracle; the kernels, Pallas and CUDA, give 0 there.
    """
    b, h, d = q.shape
    s, hkv = k_data.shape[1], k_data.shape[2]
    groups = h // hkv
    qf = q.float().reshape(b, hkv, groups, d)
    kf = k_data.float() * k_scale.float()
    vf = v_data.float() * v_scale.float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, kf) * sm_scale
    mask = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)


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
        # room for this step's token; a row past even that (a draft step
        # beyond its own window) drops it, as JAX's scatter does
        g = torch.cat([g, g.new_zeros(b, 1, hkv, d)], dim=1)
        inside = lengths <= s
        g[rows[inside], lengths[inside]] = nf[inside]
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
