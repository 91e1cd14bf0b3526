"""Paged chunk-prefill GQA attention: the CUDA kernel's wrapper, its launch
plan and its plain version.

The kernel (``csrc/paged_prefill.cu``) replaces
``repro/kernels/paged_prefill.py::paged_mqa_prefill_pallas``: a C-token
query chunk against the pages holding each row's ``ctx_lens`` cached tokens
plus the chunk's own K/V under a causal mask, with the same in-register
dequant and window as the decode kernel.  Query rows are tiled across blocks
and the head dim is zero-padded to 32, 64, 128 or 256
(:func:`padded_head_dim`); see the source note.  A bf16 query takes
``ROWS_PER_BLOCK`` rows to a block (:func:`launch_grid`).  A float32 query
(a float32 model) takes the f32 kernel (``paged_prefill_f32``: f32 output,
f32 16-bit pools, both products on the tensor cores from bf16 terms of q, K,
V and P, f32-accurate as the JAX kernel's f32 products): blocks of 16, 32 or
64 rows whose warps split the keys of a tile, and at small grids a split of
each row block's key tiles over several blocks with a merge launch
(:func:`prefill_plan`, from the shapes alone).  The plain version is
:func:`repro_torch.kernels.ref.paged_mqa_prefill_ref`, which the dispatch
wrapper (``ops.paged_mqa_prefill``) runs for CPU tensors.

``paged_mqa_prefill_cuda.launches`` counts the calls that launched the bf16
kernel, ``.f32_launches`` those that launched the f32 one and
``.f32_merge_launches`` the f32 calls that also launched its merge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, paged_dtypes, ptr, window_arg
from repro_torch.kernels.mpmm import SMS
from repro_torch.kernels.ref import paged_mqa_prefill_ref

__all__ = ["keys_per_tile", "launch_grid", "padded_head_dim", "paged_mqa_prefill_cuda",
           "paged_mqa_prefill_ref", "prefill_plan", "row_warps", "smem_bytes", "split_tiles"]

ROWS_PER_BLOCK = 64  # query rows of a bf16 block, 16 per warp (csrc: PF_TQ)
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is compiled for (csrc: DP)
KEYS_PER_TILE = 64  # keys a tile holds (csrc: PfSmem::KT; PfF32::KT where it fits)
SMEM_MAX = 227 * 1024  # shared memory a block may have on an H100 (csrc: PF_SMEM_MAX)
WARPS = 4  # warps a block (csrc: PF_THREADS / 32)
MAX_SPLITS = 64  # key splits of an f32 row block (csrc: PF_MAX_SPLITS)


def padded_head_dim(d: int) -> int:
    """The head dim the kernel pads ``d`` to in shared memory."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"paged prefill kernel takes head dims up to {HEAD_DIMS[-1]}, got {d}")


def row_warps(rows: int, itemsize: int = 2) -> int:
    """16-row warps a block takes for ``rows`` = C * G query rows: 4 for a
    bf16 query; for f32 the fewest of 1, 2, 4 that hold them (csrc:
    pf32_row_warps)."""
    if itemsize == 2:
        return WARPS
    return 1 if rows <= 16 else 2 if rows <= 32 else 4


def _f32_bytes(dp: int, kv_bits: int, rw: int, kt: int) -> int:
    q_terms = (2 if kv_bits == 16 else 3) * 16 * rw * (dp + 8) * 2
    if kv_bits == 16:
        return q_terms + 2 * 2 * kt * (4 * dp + 16)
    raw = kt * (dp if kv_bits == 8 else dp // 2)
    return q_terms + 3 * (2 * raw + 2 * kt * 4) + 2 * kt * (dp + 8) * 2 + 2 * kt * 4


def keys_per_tile(dp: int, itemsize: int, kv_bits: int = 8, rw: int = WARPS) -> int:
    """Keys of one K / V tile of the instantiation at padded head dim ``dp``
    for a query of ``itemsize`` bytes (2: bf16, 4: f32), ``kv_bits`` and
    ``rw`` row warps: ``KEYS_PER_TILE``, or for f32 32 where 64 would not fit
    in ``SMEM_MAX`` (csrc: pf32_keys_per_tile)."""
    if itemsize == 2 or _f32_bytes(dp, kv_bits, rw, KEYS_PER_TILE) <= SMEM_MAX:
        return KEYS_PER_TILE
    return KEYS_PER_TILE // 2


def smem_bytes(dp: int, kv_bits: int, itemsize: int, rw: int = WARPS) -> int:
    """Dynamic shared memory of that instantiation (csrc:
    paged_prefill_smem_bytes).  bf16: the Q tile, the ring of K / V tiles
    (kv16: 2 stages the products read), or of raw payload and scales (kv8 /
    kv4: 3 stages) plus the converted tiles and per-key factors.  f32: the
    bf16 terms of q (3, or 2 against an f32 kv16 pool) for 16 ``rw`` rows,
    then 2 stages of f32 kv16 rows split in place, or the int ring, tiles and
    factors as for bf16.  Rows are padded by 16 bytes (an odd multiple of 16
    bytes a row)."""
    if itemsize == 4:
        return _f32_bytes(dp, kv_bits, rw, keys_per_tile(dp, 4, kv_bits, rw))
    kt, tp = KEYS_PER_TILE, dp + 8
    tile = kt * tp * 2
    q_tile = ROWS_PER_BLOCK * tp * 2
    if kv_bits == 16:
        return q_tile + 2 * 2 * tile
    raw = kt * (dp if kv_bits == 8 else dp // 2)
    return q_tile + 3 * (2 * raw + 2 * kt * 4) + 2 * tile + 2 * kt * 4


def launch_grid(b: int, hkv: int, c: int, g: int) -> tuple[int, int, int]:
    """The bf16 kernel's grid: (batch, kv head, block of ``ROWS_PER_BLOCK``
    of the C * G query rows r = c * G + g)."""
    return b, hkv, -(-(c * g) // ROWS_PER_BLOCK)


def prefill_plan(b: int, hkv: int, c: int, g: int, d: int, w: int, ps: int, window=None,
                 kv_bits: int = 8, itemsize: int = 2) -> dict:
    """How ``paged_mqa_prefill_cuda`` launches, from the shapes alone (never
    ``ctx_lens`` or ``q_lens``, so a captured step replays it).  bf16: 64-row
    blocks, one split.  f32: blocks of 16 ``row_warps`` rows (the fewest that
    hold C * G), whose ``4 // row_warps`` warps a row group (at most
    ``keys_per_tile // 16``) split each tile's keys; and where the
    (b, kv head, row block) blocks are under one wave of ``SMS``, each row
    block's key tiles split over ``splits`` blocks, at most the tiles a row
    block can walk (the table's capacity, or the window where that is
    smaller, plus the chunk) and ``MAX_SPLITS``.  The split each block takes
    is computed on the card from the lengths; a merge launch then combines
    the splits in order.  paligemma-3b's verify window (8 rows x 1 x 8 x
    256, C 5, 51 pages of 16) takes 4-row-warp blocks of 32-key tiles and 17
    splits; llama3.2-3b's 128-token chunk (4 x 8 x 3, 6 row blocks a head)
    none."""
    dp = padded_head_dim(d)
    rows = c * g
    rw = row_warps(rows, itemsize)
    kt = keys_per_tile(dp, itemsize, kv_bits, rw)
    blocks = b * hkv * -(-rows // (16 * rw))
    splits = 1
    if itemsize == 4 and blocks < SMS:
        cap = w * ps
        span = cap if window is None else min(cap, int(window))
        chunk = c if window is None else min(c, int(window))
        tiles = -(-span // kt) + -(-chunk // kt)
        splits = max(1, min(-(-SMS // blocks), tiles, MAX_SPLITS))
    key_warps = 1 if itemsize == 2 else min(WARPS // rw, kt // 16)
    return {"rows_per_block": 16 * rw, "row_warps": rw, "key_warps": key_warps,
            "keys_per_tile": kt, "splits": splits,
            "grid": (b, hkv, -(-rows // (16 * rw)) * splits)}


def split_tiles(ctx: int, q_len: int, r0: int, nr: int, g: int, w: int, ps: int, window,
                kt: int, splits: int) -> list:
    """The key tiles each split of one f32 row block (query rows [r0, r0 +
    nr), ``g`` a chunk position) walks, as the kernel computes them on the
    card from ``ctx_lens`` and ``q_lens`` (csrc: pf_tiles): the pool
    positions from its first query's window start to ctx (at most the
    table's w * ps), then the chunk keys up to its last query's, ``kt`` a
    tile, in runs of ceil(tiles / splits) tiles, one run a split (splits
    past the last run write nothing; a block with no tile keeps one empty
    split, which writes its rows).  A tile is (kind, first, end): "pool"
    positions or "chunk" keys [first, end)."""
    c_first, c_last = r0 // g, (r0 + nr - 1) // g
    pool_end = min(ctx, w * ps)
    win_lo = max(ctx + c_first + 1 - window, 0) if window else 0
    j_lo = max(c_first + 1 - window, 0) if window else 0
    j_end = min(q_len, c_last + 1)
    tiles = [("pool", p, min(p + kt, pool_end)) for p in range(win_lo, pool_end, kt)]
    tiles += [("chunk", j, min(j + kt, j_end)) for j in range(j_lo, j_end, kt)]
    per = max(1, -(-len(tiles) // splits))
    return [tiles[i:i + per] for i in range(0, len(tiles), per)] or [[]]


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
    win = window_arg(window)
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
            tables.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(), chunk_k.data_ptr(),
            chunk_v.data_ptr(), ptr(chunk_k_scale), ptr(chunk_v_scale), out.data_ptr())
    ints = (b, int(layer), n_pages, ps, hkv, g, d, w, c, kv_bits, win)
    stream = torch.cuda.current_stream(dev).cuda_stream
    splits = 1
    if not f32:
        entry = "paged_prefill_bf16"
        err = _build.lib().paged_prefill_bf16(*head, *ints, float(sm_scale), stream)
    else:
        splits = prefill_plan(b, hkv, c, g, d, w, ps, win or None, kv_bits, 4)["splits"]
        if splits == 1:
            entry = "paged_prefill_f32"
            err = _build.lib().paged_prefill_f32(*head, *ints, float(sm_scale), stream)
        else:
            entry = "paged_prefill_f32_split"
            part = torch.empty((b, hkv, c * g, splits, 4 * -(-d // 4) + 4), dtype=torch.float32,
                               device=dev)
            err = _build.lib().paged_prefill_f32_split(*head, part.data_ptr(), *ints, splits,
                                                       float(sm_scale), stream)
    _build.check(err, entry)
    if not f32:
        paged_mqa_prefill_cuda.launches += 1
    else:
        paged_mqa_prefill_cuda.f32_launches += 1
        paged_mqa_prefill_cuda.f32_merge_launches += splits > 1
    return out


paged_mqa_prefill_cuda.launches = 0  # the bf16 kernel
paged_mqa_prefill_cuda.f32_launches = 0  # the f32 kernel
paged_mqa_prefill_cuda.f32_merge_launches = 0  # ... and its merge, where it split the keys
