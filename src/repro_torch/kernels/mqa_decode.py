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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect
from repro_torch.kernels.mpmm import SMS
from repro_torch.kernels.ref import mqa_decode_ref

__all__ = ["decode_plan", "mqa_decode_cuda", "mqa_decode_ref"]

MAX_HEAD_DIM = 128  # head dims the kernel takes (csrc: MQA_DMAX)
GROUP_QUERIES = 4  # queries a block takes at most; larger groups split (csrc: MQA_GMAX)
BLOCK_HEADS = 4  # adjacent kv heads a block takes, one per warp (csrc: MQA_WARPS)
SPLIT_UNIT = 8  # positions per tile: splits cover whole tiles (csrc: MQA_TT)
MIN_SPLIT = 64  # a split keeps at least this many positions
TARGET_BLOCKS = 4 * SMS  # at most four blocks per SM: one wave, copies in flight on all


def decode_plan(b: int, hkv: int, g: int, s: int) -> dict:
    """How ``mqa_decode_cuda`` launches rows of at most ``s`` positions: the
    query groups per (row, kv head), the split of the positions (whole
    tiles, the splits covering ``s``) and the grid (row, kv-head block x
    query group, split).  Positions are split until the grid nears
    ``TARGET_BLOCKS`` without passing it, but not below ``MIN_SPLIT``
    positions a split: zamba2-7b's serving shape (8 rows x 8 blocks of 4 kv
    heads, 552 positions) takes 8 splits, 512 blocks; its 32k context (8
    blocks) 66 splits, 528 blocks."""
    groups = -(-g // GROUP_QUERIES)
    units = b * -(-hkv // BLOCK_HEADS) * groups
    want = max(1, min(TARGET_BLOCKS // units, s // MIN_SPLIT))
    per = -(-s // want)
    per = -(-per // SPLIT_UNIT) * SPLIT_UNIT
    splits = -(-s // per)
    return {"groups": groups, "splits": splits, "per_split": per,
            "grid": (b, -(-hkv // BLOCK_HEADS) * groups, splits)}


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
    b, hkv, g, d = q.shape
    s = k_data.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("mqa_decode_cuda takes CUDA tensors")
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    dk = d // 2 if kv_bits == 4 else d
    if d % 2 or dk % 4:
        raise ValueError(f"K/V rows of {dk} bytes (head dim {d}) are not whole 32-bit words")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the decode kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    expect(q, "q", q.dtype, (b, hkv, g, d), dev)
    for name, t in (("k_data", k_data), ("v_data", v_data)):
        expect(t, name, torch.int8, (b, s, hkv, dk), dev, align=4)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        expect(t, name, torch.float32, (b, s, hkv, 1), dev, align=4)
    expect(lengths, "lengths", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    plan = decode_plan(b, hkv, g, s)
    splits = plan["splits"]
    part = (torch.empty((b, hkv, splits, g * (d + 2)), dtype=torch.float32, device=dev)
            if splits > 1 else out)
    err = _build.lib().mqa_decode(
        q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, s, hkv, g, d, kv_bits, int(q.dtype == torch.float32), splits, plan["per_split"],
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "mqa_decode")
    mqa_decode_cuda.launches += 1
    return out


mqa_decode_cuda.launches = 0
