"""Paged flash-decode GQA attention: the CUDA kernel's wrapper and its plain
version.

The kernel (``csrc/paged_decode.cu``) replaces
``repro/kernels/paged_decode.py::paged_mqa_decode_pallas``: one new token per
row against the paged KV pool, read in place through the page tables, with
int8/int4 pages dequantized in registers, an optional sliding window and the
step's own token fused in as the last term.  It is bound by the live K/V
bytes.  Each row's positions are split across blocks (flash-decoding) and a
second launch merges the splits; see the source note for its design.  The plain version is
:func:`repro_torch.kernels.ref.paged_mqa_decode_ref`, which the dispatch
wrapper (``ops.paged_mqa_decode``) runs for CPU tensors.

``paged_mqa_decode_cuda.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, pool_dtype, ptr, window_arg
from repro_torch.kernels.ref import paged_mqa_decode_ref

__all__ = ["paged_mqa_decode_cuda", "paged_mqa_decode_ref"]

_SPLIT_TOKENS = 128  # positions one block covers, at least


def decode_splits(capacity: int, tile: int) -> tuple[int, int]:
    """(splits, positions per split) for rows of at most ``capacity``
    positions (the table width times the page size, known on the host
    without reading the lengths back): about 128 positions per block, a
    whole number of ``tile``-token tiles each, at most 64 splits."""
    splits = max(1, min(64, -(-capacity // _SPLIT_TOKENS)))
    per = -(-capacity // splits)
    per = -(-per // tile) * tile
    return -(-capacity // per), per


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
        expect(t, name, pdt, (n_layers, n_pages, ps, hkv, dk), dev)
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        expect(t, name, pdt, (b, hkv, dk), dev)
    if kv_bits < 16:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            expect(t, name, torch.float32, (n_layers, n_pages, ps, hkv, 1), dev)
        for name, t in (("new_k_scale", new_k_scale), ("new_v_scale", new_v_scale)):
            expect(t, name, torch.float32, (b, hkv, 1), dev)
    else:
        k_scale = v_scale = new_k_scale = new_v_scale = None
    expect(tables, "tables", torch.int32, (b, w), dev)
    expect(lengths, "lengths", torch.int32, (b,), dev)
    lib = _build.lib()
    splits, per_split = decode_splits(w * ps, lib.paged_decode_tile_tokens())
    out = torch.empty_like(q)
    part = torch.empty((b, hkv, splits, g * (d + 2)), dtype=torch.float32, device=dev)
    err = lib.paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), lengths.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), ptr(new_k_scale), ptr(new_v_scale), out.data_ptr(),
        part.data_ptr(), b, int(layer), n_pages, ps, hkv, g, d, w, kv_bits,
        window_arg(window), splits, per_split, float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "paged_decode_bf16")
    paged_mqa_decode_cuda.launches += 1
    return out


paged_mqa_decode_cuda.launches = 0
