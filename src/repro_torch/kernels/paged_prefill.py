"""Paged chunk-prefill GQA attention: the CUDA kernel's wrapper and its plain
version.

The kernel (``csrc/paged_prefill.cu``) replaces
``repro/kernels/paged_prefill.py::paged_mqa_prefill_pallas``: a C-token
query chunk against the pages holding each row's ``ctx_lens`` cached tokens
plus the chunk's own K/V under a causal mask, with the same in-register
dequant and window as the decode kernel.  Query rows are tiled across blocks,
``ROWS_PER_BLOCK`` to a block (:func:`launch_grid`), and the head dim is
zero-padded to 32, 64, 128 or 256 (:func:`padded_head_dim`); see the
source note.  The plain version is
:func:`repro_torch.kernels.ref.paged_mqa_prefill_ref`, which the dispatch
wrapper (``ops.paged_mqa_prefill``) runs for CPU tensors.

``paged_mqa_prefill_cuda.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, pool_dtype, ptr, window_arg
from repro_torch.kernels.ref import paged_mqa_prefill_ref

__all__ = ["launch_grid", "padded_head_dim", "paged_mqa_prefill_cuda",
           "paged_mqa_prefill_ref"]

ROWS_PER_BLOCK = 64  # query rows of one block, 16 per warp (csrc: PF_TQ)
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is compiled for (csrc: DP)


def padded_head_dim(d: int) -> int:
    """The head dim the kernel pads ``d`` to in shared memory."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"paged prefill kernel takes head dims up to {HEAD_DIMS[-1]}, got {d}")


def launch_grid(b: int, hkv: int, c: int, g: int) -> tuple[int, int, int]:
    """The kernel's grid: (batch, kv head, block of ``ROWS_PER_BLOCK`` of
    the C * G query rows r = c * G + g)."""
    return b, hkv, -(-(c * g) // ROWS_PER_BLOCK)


def paged_mqa_prefill_cuda(
    q: torch.Tensor,  # [B, Hkv, C, G, D] bf16
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, Dk] int8 payload or bf16
    v_pool: torch.Tensor,
    k_scale,  # [L, P, ps, Hkv, 1] f32, or None when kv_bits == 16
    v_scale,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    ctx_lens: torch.Tensor,  # [B] int32 tokens already in the pool
    q_lens: torch.Tensor,  # [B] int32 valid chunk tokens per row
    layer: int,
    chunk_k: torch.Tensor,  # [B, Hkv, C, Dk] this chunk's K/V, not yet pooled
    chunk_v: torch.Tensor,
    chunk_k_scale,  # [B, Hkv, C, 1] f32, or None
    chunk_v_scale,
    *,
    kv_bits: int,
    sm_scale: float,
    window=None,
) -> torch.Tensor:
    """Launch the paged prefill kernel; returns [B, Hkv, C, G, D] bf16."""
    b, hkv, c, g, d = q.shape
    n_layers, n_pages, ps = k_pool.shape[:3]
    w = tables.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("paged_mqa_prefill_cuda takes CUDA tensors")
    if d % 2 or not 0 <= int(layer) < n_layers:
        raise ValueError(f"bad head dim {d} or layer {layer}")
    padded_head_dim(d)
    dk = d // 2 if kv_bits == 4 else d
    pdt = pool_dtype(kv_bits)
    if (dk * pdt.itemsize) % 4:
        raise ValueError(f"K/V rows of {dk * pdt.itemsize} bytes are not whole 32-bit words")
    expect(q, "q", torch.bfloat16, (b, hkv, c, g, d), dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        expect(t, name, pdt, (n_layers, n_pages, ps, hkv, dk), dev)
    for name, t in (("chunk_k", chunk_k), ("chunk_v", chunk_v)):
        expect(t, name, pdt, (b, hkv, c, dk), dev)
    if kv_bits < 16:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            expect(t, name, torch.float32, (n_layers, n_pages, ps, hkv, 1), dev)
        for name, t in (("chunk_k_scale", chunk_k_scale), ("chunk_v_scale", chunk_v_scale)):
            expect(t, name, torch.float32, (b, hkv, c, 1), dev)
    else:
        k_scale = v_scale = chunk_k_scale = chunk_v_scale = None
    expect(tables, "tables", torch.int32, (b, w), dev)
    expect(ctx_lens, "ctx_lens", torch.int32, (b,), dev)
    expect(q_lens, "q_lens", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    lib = _build.lib()
    err = lib.paged_prefill_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(),
        chunk_k.data_ptr(), chunk_v.data_ptr(), ptr(chunk_k_scale),
        ptr(chunk_v_scale), out.data_ptr(), b, int(layer), n_pages, ps, hkv, g,
        d, w, c, kv_bits, window_arg(window), float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "paged_prefill_bf16")
    paged_mqa_prefill_cuda.launches += 1
    return out


paged_mqa_prefill_cuda.launches = 0
