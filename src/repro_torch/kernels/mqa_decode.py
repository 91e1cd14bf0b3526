"""Flash-decode GQA attention over a contiguous int8/int4 KV cache: the CUDA
kernel's wrapper and its plain version.

The kernel (``csrc/mqa_decode.cu``) replaces
``repro/kernels/mqa_decode.py::mqa_decode_pallas``: one query token per row
against the row's first ``lengths[b]`` cached tokens, K/V kept int8 / int4
in shared memory (fed by ``cp.async`` ahead of the arithmetic) and
converted in registers, their per-(token, head) scales applied after the
products.  It is bound by the live K/V bytes and by the latency of each
block's chain of tiles: each warp runs its own online softmax over its own
tiles, and each row's positions are split across blocks by
:func:`decode_plan` (from the shape, never reading ``lengths`` back), with a
second launch merging the splits in a fixed order when there is more than
one; see the source note for its design.  The plain version is
:func:`repro_torch.kernels.ref.mqa_decode_ref`, which the dispatch wrapper
(``ops.mqa_decode``) runs for CPU tensors.

``mqa_decode_cuda.launches`` counts the calls that launched the kernel.
:func:`mqa_decode_contract` is the kernel's contract on meta tensors (the
dry run): ``mqa_decode_cuda``'s checks and allocations
(:func:`launch_buffers`), nothing launched.  :func:`decode_cost` is the work
of one call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect
from repro_torch.kernels.mpmm import SMS
from repro_torch.kernels.ref import mqa_decode_ref

__all__ = ["decode_plan", "mqa_decode_contract", "mqa_decode_cuda", "mqa_decode_ref"]

MAX_HEAD_DIM = 256  # head dims the kernel takes (csrc: MQA_DMAX)
NARROW_HEAD_DIM = 128  # D up to this takes the narrow instantiation (csrc: MQA_DMAX_NARROW)
GROUP_QUERIES = 4  # queries a block takes at most at D <= 128 (csrc: MQA_GMAX)
GROUP_QUERIES_WIDE = 2  # ... and at D 129-256, q in registers (csrc: MQA_GMAX_WIDE)
BLOCK_HEADS = 4  # adjacent kv heads a block takes, one per warp (csrc: MQA_WARPS)
SPLIT_UNIT = 8  # positions per tile: splits cover whole tiles (csrc: MQA_TT)
MIN_SPLIT = 64  # a split keeps at least this many positions
TARGET_BLOCKS = 4 * SMS  # at most four 4-warp blocks per SM: one wave, copies in flight on all


def group_queries(d: int) -> int:
    """Queries a block takes at most at head dim ``d``."""
    return GROUP_QUERIES if d <= NARROW_HEAD_DIM else GROUP_QUERIES_WIDE


def decode_plan(b: int, hkv: int, g: int, s: int, d: int = NARROW_HEAD_DIM) -> dict:
    """How ``mqa_decode_cuda`` launches rows of at most ``s`` positions at
    head dim ``d``: the query groups per (row, kv head) (at most
    :func:`group_queries` queries each), the split of the positions (whole
    tiles, the splits covering ``s``) and the grid (row, kv-head block x
    query group, split).  A block runs a warp a kv head, at most
    ``BLOCK_HEADS``.  Positions are split until the grid's warps near
    ``TARGET_BLOCKS`` blocks of ``BLOCK_HEADS`` warps (half that at D > 128,
    whose warps hold ~220 registers: 9 fit an SM) without passing them, but
    not below ``MIN_SPLIT`` positions a split: zamba2-7b's serving shape (8
    rows x 8 blocks of 4 kv heads, 552 positions) takes 8 splits, 512
    blocks; its 32k context (8 blocks) 66 splits, 528 blocks; paligemma-3b's
    decode_32k rank (8 rows, one kv head, so one-warp blocks, 8 queries of D
    256: 4 groups of 2) 33 splits, 1056 blocks, the fastest of 1-512 splits
    in ``tools/sweep_mqa_decode.py`` on the H100 (0.35 ms at 33, 0.43 at 66,
    0.55 at 16)."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the decode kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    groups = -(-g // group_queries(d))
    units = b * -(-hkv // BLOCK_HEADS) * groups
    warps = min(hkv, BLOCK_HEADS)
    target = TARGET_BLOCKS * BLOCK_HEADS // (2 if d > NARROW_HEAD_DIM else 1)
    want = max(1, min(target // (units * warps), s // MIN_SPLIT))
    per = -(-s // want)
    per = -(-per // SPLIT_UNIT) * SPLIT_UNIT
    splits = -(-s // per)
    return {"groups": groups, "splits": splits, "per_split": per,
            "grid": (b, -(-hkv // BLOCK_HEADS) * groups, splits)}


def decode_cost(b: int, hkv: int, g: int, d: int, positions: int, kv_bits: int,
                q_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one call over ``positions`` cached tokens in all
    (the rows' lengths summed): QK and PV, 4·Hkv·G·D a position; each
    position's K and V payload (D / 2 bytes a head at kv4) and f32 scales, q
    and the output (``q_bytes`` an element) and the lengths moved once.
    Shapes alone give no lengths: the dry run counts every position of the
    cache (``positions = B·S``), the full cache a decode cell attends to."""
    dk = d // 2 if kv_bits == 4 else d
    return (4 * hkv * g * d * positions,
            2 * positions * hkv * (dk + 4) + 2 * b * hkv * g * d * q_bytes + 4 * b)


def launch_buffers(q, k_data, v_data, k_scale, v_scale, lengths, kv_bits: int):
    """The kernel's checks on CUDA or meta tensors (q [B, Hkv, G, D], the
    layout of :func:`mqa_decode_cuda`), then what a launch allocates: (out
    in q's dtype, the f32 buffer of its position splits (``out`` itself
    when it has one split), its :func:`decode_plan`)."""
    b, hkv, g, d = q.shape
    s = k_data.shape[1]
    dev = q.device
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    dk = d // 2 if kv_bits == 4 else d
    if d % 2 or dk % 4:
        raise ValueError(f"K/V rows of {dk} bytes (head dim {d}) are not whole 32-bit words")
    expect(q, "q", q.dtype, (b, hkv, g, d), dev)
    for name, t in (("k_data", k_data), ("v_data", v_data)):
        expect(t, name, torch.int8, (b, s, hkv, dk), dev, align=4)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        expect(t, name, torch.float32, (b, s, hkv, 1), dev, align=4)
    expect(lengths, "lengths", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    plan = decode_plan(b, hkv, g, s, d)
    part = (torch.empty((b, hkv, plan["splits"], g * (d + 2)), dtype=torch.float32,
                        device=dev)
            if plan["splits"] > 1 else out)
    return out, part, plan


def mqa_decode_contract(q, k_data, v_data, k_scale, v_scale, lengths, *, kv_bits: int,
                        sm_scale: float) -> torch.Tensor:
    """The kernel on meta tensors: :func:`mqa_decode_cuda`'s checks and
    allocations, its output returned, nothing launched."""
    if not q.is_meta:
        raise ValueError("mqa_decode_contract takes meta tensors")
    return launch_buffers(q, k_data, v_data, k_scale, v_scale, lengths, kv_bits)[0]


def mqa_decode_cuda(
    q: torch.Tensor,  # [B, Hkv, G, D] bf16 or f32
    k_data: torch.Tensor,  # [B, S, Hkv, D (/2 if kv_bits==4)] int8
    v_data: torch.Tensor,
    k_scale: torch.Tensor,  # [B, S, Hkv, 1] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    *,
    kv_bits: int,
    sm_scale: float,
) -> torch.Tensor:
    """Launch the decode kernel; returns [B, Hkv, G, D] in q's dtype."""
    if not q.is_cuda:
        raise ValueError("mqa_decode_cuda takes CUDA tensors")
    out, part, plan = launch_buffers(q, k_data, v_data, k_scale, v_scale, lengths, kv_bits)
    b, hkv, g, d = q.shape
    err = _build.lib().mqa_decode(
        q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, k_data.shape[1], hkv, g, d, kv_bits, int(q.dtype == torch.float32),
        plan["splits"], plan["per_split"], float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mqa_decode")
    mqa_decode_cuda.launches += 1
    return out


mqa_decode_cuda.launches = 0
