"""Paged flash-decode GQA attention: the CUDA kernel's wrapper, its launch
plan and its plain version.

The kernel (``csrc/paged_decode.cu``) replaces
``repro/kernels/paged_decode.py::paged_mqa_decode_pallas``: one new token per
row against the paged KV pool, read in place through the page tables, with
an optional sliding window and the step's own token fused in.  It is bound
by the live K/V bytes and by the latency of each warp's chain of tiles: a
warp is a whole decoder of one (row, kv head, group of up to 8 queries,
split), streams its pages as stored (int8, packed int4 or bf16) through its
own ``cp.async`` ring with the page ids looked up a tile ahead, and runs
both products on the tensor cores with the query group as the M side; a
float32 query (a float32 model) takes the f32 instantiation
(``paged_decode_f32``: f32 output, f32 16-bit pools, both products as f32
FMAs, as the JAX kernel computes them in f32).  :func:`decode_plan` splits
each row's positions from the shapes alone (never reading ``lengths``
back); a second launch merges the splits in a fixed order; see the source
note for its design.  The plain version is
:func:`repro_torch.kernels.ref.paged_mqa_decode_ref`, which the dispatch
wrapper (``ops.paged_mqa_decode``) runs for CPU tensors.

``paged_mqa_decode_cuda.launches`` counts the calls that launched the bf16
instantiation, ``.f32_launches`` those that launched the f32 one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, paged_dtypes, ptr, window_arg
from repro_torch.kernels.mpmm import SMS
from repro_torch.kernels.ref import paged_mqa_decode_ref

__all__ = ["block_warps", "decode_plan", "decode_smem_bytes", "paged_mqa_decode_cuda",
           "paged_mqa_decode_ref"]

MAX_HEAD_DIM = 256  # 8 groups of 32 dims in the P V fragments (csrc: NC)
GROUP_QUERIES = 8  # queries a warp takes: the products' M rows (csrc: PD_GQ)
TILE = 8  # positions per warp tile: splits cover whole tiles (csrc: PD_TT)
BLOCK_WARPS = 4  # warps a block takes at most (csrc: PD_MAX_WARPS)
RING = 4  # tiles in each warp's ring (csrc: PD_RING)
SMEM_MAX = 227 * 1024  # shared memory a block may have on an H100 (csrc: PD_SMEM_MAX)
MAX_SPLITS = 64  # splits a row takes at most (csrc: PD_MAX_SPLITS)
MIN_SPLIT = 16  # a split keeps at least this many positions
TARGET_WARPS = 4 * BLOCK_WARPS * SMS  # four blocks per SM: copies in flight on all


def decode_smem_bytes(d: int, kv_bits: int, itemsize: int, warps: int = BLOCK_WARPS) -> int:
    """Shared memory of a block of ``warps`` warps: each a ring of ``RING``
    tiles of ``TILE`` K rows, ``TILE`` V rows (stored rows padded to 16 x
    an odd number of bytes) and, for int payloads, their f32 scales.  A
    16-bit pool holds the query's type, ``itemsize`` bytes a value."""
    dk = d * itemsize if kv_bits == 16 else d * kv_bits // 8
    pitch = -(-dk // 16) * 16
    if (pitch // 16) % 2 == 0:
        pitch += 16
    tile = 2 * TILE * pitch + (2 * TILE * 4 if kv_bits < 16 else 0)
    return warps * RING * tile


def block_warps(d: int, kv_bits: int, itemsize: int) -> int:
    """Warps a block takes: ``BLOCK_WARPS``, halved while their rings would
    not fit in ``SMEM_MAX`` (f32 kv16 pools past D 220 take 2)."""
    warps = BLOCK_WARPS
    while warps > 1 and decode_smem_bytes(d, kv_bits, itemsize, warps) > SMEM_MAX:
        warps //= 2
    return warps


def decode_plan(b: int, hkv: int, g: int, d: int, w: int, ps: int, window=None,
                kv_bits: int = 8, itemsize: int = 2) -> dict:
    """How ``paged_mqa_decode_cuda`` launches ``b`` rows of a table of ``w``
    pages of ``ps`` positions, from the shapes alone (never the lengths): the
    query groups per (row, kv head) (at most ``GROUP_QUERIES`` queries a
    warp), and the split of the positions a row can span, the table's
    capacity or the window where that is smaller, into whole tiles.  The
    splits grow until the warps of full rows near ``TARGET_WARPS``, but not
    below ``MIN_SPLIT`` positions or past ``MAX_SPLITS``.  llama3.2-3b's
    serving shape (8 rows x 8 kv heads x 3 queries, 65 pages of 16) takes
    33 splits of 32 positions, 528 blocks of 4 warps (4 an SM); a window of
    256 there 16 of 16.  ``d`` only has to fit (``MAX_HEAD_DIM``); with
    ``kv_bits`` and the query's ``itemsize`` (2: bf16, 4: f32) it sets the
    warps a block takes (:func:`block_warps`), hence the grid."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the paged decode kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    groups = -(-g // GROUP_QUERIES)
    cap = w * ps
    span = cap if window is None else min(cap, int(window))
    units = b * hkv * groups
    want = max(1, min(TARGET_WARPS // units, span // MIN_SPLIT, MAX_SPLITS))
    per = -(-span // want)
    per = -(-per // TILE) * TILE
    splits = -(-span // per)
    warps = block_warps(d, kv_bits, itemsize)
    return {"groups": groups, "group_queries": -(-g // groups), "span": span,
            "splits": splits, "per_split": per, "block_warps": warps,
            "grid": (b, -(-hkv * groups * splits // warps))}


def paged_mqa_decode_cuda(
    q: torch.Tensor,  # [B, Hkv, G, D] bf16 or f32
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, Dk] int8 payload, or q's type
    v_pool: torch.Tensor,
    k_scale,  # [L, P, ps, Hkv, 1] f32, or None when kv_bits == 16
    v_scale,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    lengths: torch.Tensor,  # [B] int32 tokens already in the cache
    layer: int,
    new_k: torch.Tensor,  # [B, Hkv, Dk] this step's K/V, not yet in the pool
    new_v: torch.Tensor,
    new_k_scale,  # [B, Hkv, 1] f32, or None
    new_v_scale,
    *,
    kv_bits: int,
    sm_scale: float,
    window=None,
) -> torch.Tensor:
    """Launch the paged decode kernel's instantiation for ``q``'s type;
    returns [B, Hkv, G, D] of that type."""
    b, hkv, g, d = q.shape
    n_layers, n_pages, ps = k_pool.shape[:3]
    w = tables.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("paged_mqa_decode_cuda takes CUDA tensors")
    if d % 2 or not 0 <= int(layer) < n_layers:
        raise ValueError(f"bad head dim {d} or layer {layer}")
    dk = d // 2 if kv_bits == 4 else d
    pdt, _ = paged_dtypes(q.dtype, kv_bits)
    if (dk * pdt.itemsize) % 4:
        raise ValueError(f"K/V rows of {dk * pdt.itemsize} bytes are not whole 32-bit words")
    expect(q, "q", q.dtype, (b, hkv, g, d), dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        expect(t, name, pdt, (n_layers, n_pages, ps, hkv, dk), dev, align=4)
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        expect(t, name, pdt, (b, hkv, dk), dev, align=4)
    if kv_bits < 16:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            expect(t, name, torch.float32, (n_layers, n_pages, ps, hkv, 1), dev)
        for name, t in (("new_k_scale", new_k_scale), ("new_v_scale", new_v_scale)):
            expect(t, name, torch.float32, (b, hkv, 1), dev)
    else:
        k_scale = v_scale = new_k_scale = new_v_scale = None
    expect(tables, "tables", torch.int32, (b, w), dev)
    expect(lengths, "lengths", torch.int32, (b,), dev)
    win = window_arg(window)
    plan = decode_plan(b, hkv, g, d, w, ps, win or None, kv_bits, q.element_size())
    splits = plan["splits"]
    out = torch.empty_like(q)
    part = None
    if splits > 1:
        part = torch.empty((b, hkv, g, splits, 4 * -(-d // 4) + 4), dtype=torch.float32,
                           device=dev)
    f32 = q.dtype == torch.float32
    entry = "paged_decode_f32" if f32 else "paged_decode_bf16"
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), lengths.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), ptr(new_k_scale), ptr(new_v_scale), out.data_ptr(),
        ptr(part), b, int(layer), n_pages, ps, hkv, g, d, w, kv_bits,
        win, plan["groups"], splits, plan["per_split"], float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, entry)
    if f32:
        paged_mqa_decode_cuda.f32_launches += 1
    else:
        paged_mqa_decode_cuda.launches += 1
    return out


paged_mqa_decode_cuda.launches = 0  # the bf16 instantiation
paged_mqa_decode_cuda.f32_launches = 0  # the f32 instantiation
