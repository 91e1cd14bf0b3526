"""Paged chunk-prefill GQA attention: the CUDA kernel's wrapper and its plain
version.

The kernel (``csrc/paged_prefill.cu``) replaces
``repro/kernels/paged_prefill.py::paged_mqa_prefill_pallas``: a C-token
query chunk against the pages holding each row's ``ctx_lens`` cached tokens
plus the chunk's own K/V under a causal mask, with the same in-register
dequant and window as the decode kernel.  Query rows are tiled across blocks,
``ROWS_PER_BLOCK`` to a block (:func:`launch_grid`), and the head dim is
zero-padded to 32, 64, 128 or 256 (:func:`padded_head_dim`); see the
source note.  A float32 query (a float32 model) takes the f32 instantiation
(``paged_prefill_f32``: f32 output, f32 16-bit pools, both products as f32
FMAs, as the JAX kernel computes them in f32); at DP = 256 its tiles hold
``KEYS_PER_TILE_F32_256`` keys, so that they fit in shared memory
(:func:`smem_bytes`).  The plain version is
:func:`repro_torch.kernels.ref.paged_mqa_prefill_ref`, which the dispatch
wrapper (``ops.paged_mqa_prefill``) runs for CPU tensors.

``paged_mqa_prefill_cuda.launches`` counts the calls that launched the bf16
instantiation, ``.f32_launches`` those that launched the f32 one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, paged_dtypes, ptr, window_arg
from repro_torch.kernels.ref import paged_mqa_prefill_ref

__all__ = ["keys_per_tile", "launch_grid", "padded_head_dim", "paged_mqa_prefill_cuda",
           "paged_mqa_prefill_ref", "smem_bytes"]

ROWS_PER_BLOCK = 64  # query rows of one block, 16 per warp (csrc: PF_TQ)
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is compiled for (csrc: DP)
KEYS_PER_TILE = 64  # keys a tile holds (csrc: PfSmem::KT) ...
KEYS_PER_TILE_F32_256 = 32  # ... but for f32 queries at DP = 256


def padded_head_dim(d: int) -> int:
    """The head dim the kernel pads ``d`` to in shared memory."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"paged prefill kernel takes head dims up to {HEAD_DIMS[-1]}, got {d}")


def keys_per_tile(dp: int, itemsize: int) -> int:
    """Keys of one K / V tile of the instantiation at padded head dim ``dp``
    for a query of ``itemsize`` bytes (2: bf16, 4: f32)."""
    return KEYS_PER_TILE_F32_256 if itemsize == 4 and dp == 256 else KEYS_PER_TILE


def smem_bytes(dp: int, kv_bits: int, itemsize: int) -> int:
    """Dynamic shared memory of that instantiation (csrc: PfSmem::BYTES):
    the Q tile, the ring of K / V tiles (kv16: 2 stages the products read),
    or of raw payload and scales (kv8 / kv4: 3 stages) plus the converted
    tiles and per-key factors.  Rows of the query's type are padded by 16
    bytes (an odd multiple of 16 bytes a row)."""
    kt = keys_per_tile(dp, itemsize)
    tp = dp + 16 // itemsize
    tile = kt * tp * itemsize
    q_tile = ROWS_PER_BLOCK * tp * itemsize
    if kv_bits == 16:
        return q_tile + 2 * 2 * tile
    raw = kt * (dp if kv_bits == 8 else dp // 2)
    return q_tile + 3 * (2 * raw + 2 * kt * 4) + 2 * tile + 2 * kt * 4


def launch_grid(b: int, hkv: int, c: int, g: int) -> tuple[int, int, int]:
    """The kernel's grid: (batch, kv head, block of ``ROWS_PER_BLOCK`` of
    the C * G query rows r = c * G + g), the same for every instantiation."""
    return b, hkv, -(-(c * g) // ROWS_PER_BLOCK)


def paged_mqa_prefill_cuda(
    q: torch.Tensor,  # [B, Hkv, C, G, D] bf16 or f32
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, Dk] int8 payload, or q's type
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
    """Launch the paged prefill kernel's instantiation for ``q``'s type;
    returns [B, Hkv, C, G, D] of that type."""
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
    pdt, _ = paged_dtypes(q.dtype, kv_bits)
    if (dk * pdt.itemsize) % 4:
        raise ValueError(f"K/V rows of {dk * pdt.itemsize} bytes are not whole 32-bit words")
    expect(q, "q", q.dtype, (b, hkv, c, g, d), dev)
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
    f32 = q.dtype == torch.float32
    entry = "paged_prefill_f32" if f32 else "paged_prefill_bf16"
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(),
        chunk_k.data_ptr(), chunk_v.data_ptr(), ptr(chunk_k_scale),
        ptr(chunk_v_scale), out.data_ptr(), b, int(layer), n_pages, ps, hkv, g,
        d, w, c, kv_bits, window_arg(window), float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, entry)
    if f32:
        paged_mqa_prefill_cuda.f32_launches += 1
    else:
        paged_mqa_prefill_cuda.launches += 1
    return out


paged_mqa_prefill_cuda.launches = 0  # the bf16 instantiation
paged_mqa_prefill_cuda.f32_launches = 0  # the f32 instantiation
