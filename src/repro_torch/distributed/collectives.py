"""Distributed-optimization collectives (port of
``repro/distributed/collectives.py``).

int8 gradient compression with error feedback: the paper's multi-precision
idea applied to the data-parallel gradient reduction:

    1. residual-corrected gradient  g' = g + e   (error feedback state e)
    2. blockwise int8 quantize (per-chunk f32 scales)
    3. reduce-scatter as an all-to-all of the int8 chunks and their scales
       (``all_to_all_single``: the bytes on the wire are 1/4 of f32), then
       the f32 sum of the received chunks, in peer order
    4. int8 all-gather (``all_gather_into_tensor``) of each rank's
       re-quantized reduced chunk
    5. e <- g' - dequant(result)   (what compression lost, fed back next step)

Where the JAX functions run inside ``shard_map`` over a mesh axis, these run
on every rank of a process group (``DeviceMesh.get_group(axis)``), each
rank passing its own tensors.  The arithmetic is the JAX package's, in f32:
``torch.round`` rounds half to even as ``jnp.round`` does, and every
division is a true f32 division: a divisor is a tensor on the operand's
device (``_div``), since PyTorch on the card turns a division by a Python
number into a product with its reciprocal, an ulp away in some scales.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.optim import tree

_CHUNK = 1024


def _div(a: torch.Tensor, k: float) -> torch.Tensor:
    """``a / k`` rounded as one IEEE division on every device."""
    return a / torch.full((1,), k, dtype=a.dtype, device=a.device)


def _quantize_chunks(x: torch.Tensor, n_shards: int):
    """flat f32 [n] -> (int8 [n_shards, m/CHUNK, CHUNK], scales [n_shards,
    m/CHUNK, 1] f32)."""
    n = x.shape[0]
    per = -(-n // n_shards)
    per = per + (-per) % _CHUNK
    xp = torch.nn.functional.pad(x, (0, n_shards * per - n)).reshape(
        n_shards, per // _CHUNK, _CHUNK)
    scale = _div(torch.clamp_min(xp.abs().amax(dim=-1, keepdim=True), 1e-30), 127.0)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_chunks(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n]


def _requantize(mine: torch.Tensor):
    """A reduced chunk [m/CHUNK, CHUNK] f32 -> (int8 payload, f32 scale
    [m/CHUNK, 1]), per chunk as in the first stage."""
    sc2 = _div(torch.clamp_min(mine.abs().amax(dim=-1, keepdim=True), 1e-30), 127.0)
    q2 = torch.clamp(torch.round(mine / sc2), -127, 127).to(torch.int8)
    return q2, sc2


def compressed_psum_mean(x: torch.Tensor, group=None, e2: torch.Tensor | None = None):
    """Mean-reduce `x` over the ranks of ``group`` with int8 wire traffic.

    Every rank of the group calls it with its own ``x`` (same shape).
    ``e2`` is the error-feedback state of the SECOND quantization stage
    (this rank's reduced chunk): pass the previous call's returned residual
    and both stages telescope (the cumulative reduced sum then deviates
    from the exact sum by at most one quantization step, not O(T)).  With
    e2 given, returns (mean, e1_residual, e2_residual): add e1_residual to
    next round's x.  When e2 is None only the mean is returned."""
    n_shards = dist.get_world_size(group)
    shape, n = x.shape, x.numel()
    flat = x.reshape(-1).float()
    q, scale = _quantize_chunks(flat, n_shards)  # [S, m/C, C] int8
    # stage-1 residual: what MY local quantization lost (the EF state the
    # caller must add back next round, NOT x minus the final mean)
    e1_new = (flat - _dequantize_chunks(q, scale, n)).reshape(shape)
    # reduce-scatter: rank i collects chunk i from every peer
    q_t, s_t = torch.empty_like(q), torch.empty_like(scale)
    dist.all_to_all_single(q_t, q, group=group)
    dist.all_to_all_single(s_t, scale, group=group)
    # local f32 reduction of my chunk across peers, in peer order
    mine = q_t[0].float() * s_t[0]
    for i in range(1, n_shards):
        mine = mine + q_t[i].float() * s_t[i]
    mine = _div(mine, n_shards)  # [m/C, C]
    if e2 is not None:
        mine = mine + e2
    # re-quantize my reduced chunk and all-gather int8
    q2, sc2 = _requantize(mine)
    e2_new = mine - q2.float() * sc2
    qg = q2.new_empty((n_shards * q2.shape[0], q2.shape[1]))
    sg = sc2.new_empty((n_shards * sc2.shape[0], 1))
    dist.all_gather_into_tensor(qg, q2, group=group)
    dist.all_gather_into_tensor(sg, sc2.float(), group=group)
    red = _dequantize_chunks(qg, sg, n).reshape(shape)
    if e2 is not None:
        return red, e1_new, e2_new
    return red


def compressed_grad_reduce(grads: Any, error: Any, mesh, data_axes: tuple[str, ...] = ("data",)):
    """Error-feedback int8 mean-reduction of a gradient tree over the data
    axes.  ``grads`` are this rank's own (unreduced); returns (reduced
    grads, new error state).  Leaves smaller than one chunk reduce exactly
    (an f32 all-reduce mean over every data axis); the others through
    :func:`compressed_psum_mean` over the first data axis, as in JAX."""
    groups = [mesh.get_group(a) for a in data_axes]
    n_all = 1
    for g in groups:
        n_all *= dist.get_world_size(g)

    def one(g, e):
        e1, e2 = e["e1"], e["e2"]
        gf = g.float() + e1
        if g.numel() < _CHUNK:  # tiny leaves: exact
            red = gf.clone()
            for grp in groups:
                dist.all_reduce(red, group=grp)
            red = _div(red, n_all)
            return red.to(g.dtype), {"e1": torch.zeros_like(gf), "e2": e2}
        red, e1n, e2n = compressed_psum_mean(gf, groups[0], e2)
        return red.to(g.dtype), {"e1": e1n, "e2": e2n}

    outs = [one(g, e) for g, e in zip(tree.leaves(grads), tree.subtrees(grads, error))]
    return (tree.unflatten(grads, [o[0] for o in outs]),
            tree.unflatten(grads, [o[1] for o in outs]))


def init_error_state(grads_proto: Any, n_shards: int = 1) -> Any:
    def one(g):
        per = -(-g.numel() // n_shards)
        per = per + (-per) % _CHUNK
        return {
            "e1": torch.zeros(g.shape, dtype=torch.float32, device=g.device),
            "e2": torch.zeros((per // _CHUNK, _CHUNK), dtype=torch.float32, device=g.device),
        }

    return tree.unflatten(grads_proto, [one(g) for g in tree.leaves(grads_proto)])
