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
both products on the tensor cores with the query group as the M side.
:func:`decode_plan` splits each row's positions from the shapes alone (never
reading ``lengths`` back); a second launch merges the splits in a fixed
order; see the source note for its design.  The plain version is
:func:`repro_torch.kernels.ref.paged_mqa_decode_ref`, which the dispatch
wrapper (``ops.paged_mqa_decode``) runs for CPU tensors.

``paged_mqa_decode_cuda.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, pool_dtype, ptr, window_arg
from repro_torch.kernels.mpmm import SMS
from repro_torch.kernels.ref import paged_mqa_decode_ref

__all__ = ["decode_plan", "paged_mqa_decode_cuda", "paged_mqa_decode_ref"]

MAX_HEAD_DIM = 256  # 8 groups of 32 dims in the P V fragments (csrc: NC)
GROUP_QUERIES = 8  # queries a warp takes: the products' M rows (csrc: PD_GQ)
TILE = 8  # positions per warp tile: splits cover whole tiles (csrc: PD_TT)
BLOCK_WARPS = 4  # warps a block takes (csrc: PD_MAX_WARPS)
MAX_SPLITS = 64  # splits a row takes at most (csrc: PD_MAX_SPLITS)
MIN_SPLIT = 16  # a split keeps at least this many positions
TARGET_WARPS = 4 * BLOCK_WARPS * SMS  # four blocks per SM: copies in flight on all


def decode_plan(b: int, hkv: int, g: int, d: int, w: int, ps: int, window=None) -> dict:
    """How ``paged_mqa_decode_cuda`` launches ``b`` rows of a table of ``w``
    pages of ``ps`` positions, from the shapes alone (never the lengths): the
    query groups per (row, kv head) (at most ``GROUP_QUERIES`` queries a
    warp), and the split of the positions a row can span, the table's
    capacity or the window where that is smaller, into whole tiles.  The
    splits grow until the warps of full rows near ``TARGET_WARPS``, but not
    below ``MIN_SPLIT`` positions or past ``MAX_SPLITS``.  llama3.2-3b's
    serving shape (8 rows x 8 kv heads x 3 queries, 65 pages of 16) takes
    33 splits of 32 positions, 528 blocks of 4 warps (4 an SM); a window of
    256 there 16 of 16.  ``d`` only has to fit (``MAX_HEAD_DIM``)."""
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
    return {"groups": groups, "group_queries": -(-g // groups), "span": span,
            "splits": splits, "per_split": per,
            "grid": (b, -(-hkv * groups * splits // BLOCK_WARPS))}


def paged_mqa_decode_cuda(
    q: torch.Tensor,  # [B, Hkv, G, D] bf16
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, Dk] int8 payload or bf16
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
    """Launch the paged decode kernel; returns [B, Hkv, G, D] bf16."""
    b, hkv, g, d = q.shape
    n_layers, n_pages, ps = k_pool.shape[:3]
    w = tables.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("paged_mqa_decode_cuda takes CUDA tensors")
    if d % 2 or not 0 <= int(layer) < n_layers:
        raise ValueError(f"bad head dim {d} or layer {layer}")
    dk = d // 2 if kv_bits == 4 else d
    pdt = pool_dtype(kv_bits)
    if (dk * pdt.itemsize) % 4:
        raise ValueError(f"K/V rows of {dk * pdt.itemsize} bytes are not whole 32-bit words")
    expect(q, "q", torch.bfloat16, (b, hkv, g, d), dev)
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
    plan = decode_plan(b, hkv, g, d, w, ps, win or None)
    splits = plan["splits"]
    out = torch.empty_like(q)
    part = None
    if splits > 1:
        part = torch.empty((b, hkv, g, splits, 4 * -(-d // 4) + 4), dtype=torch.float32,
                           device=dev)
    err = _build.lib().paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), lengths.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), ptr(new_k_scale), ptr(new_v_scale), out.data_ptr(),
        ptr(part), b, int(layer), n_pages, ps, hkv, g, d, w, kv_bits,
        win, plan["groups"], splits, plan["per_split"], float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "paged_decode_bf16")
    paged_mqa_decode_cuda.launches += 1
    return out


paged_mqa_decode_cuda.launches = 0
