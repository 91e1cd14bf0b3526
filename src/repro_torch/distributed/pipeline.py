"""Pipeline parallelism over the ``pod`` mesh axis, GPipe-style (port of
``repro/distributed/pipeline.py``).

CONSECUTIVE LAYER STAGES sit on the ranks of one mesh axis and microbatches
stream through them: the traffic between stages is activations (B_micro x
S x D per step boundary), not parameter gradients.  The loop runs n_micro +
n_stages - 1 ticks; at each tick stage 0 injects microbatch t, every stage
applies its params to what it holds, and the outputs move one stage
forward on the ring (``batch_isend_irecv``, the counterpart of JAX's
``ppermute``).  Bubble fraction = (S-1)/(M+S-1).  Forward only, as in the
JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import mesh_shape
from repro_torch.optim import tree


def pipeline_apply(
    stage_fn: Callable[[object, torch.Tensor], torch.Tensor],
    stage_params,  # tree, leading dim = n_stages (rank s applies slice s)
    x: torch.Tensor,  # [n_micro, B_micro, ...] microbatched input, on every rank
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Runs x through n_stages sequential stages, pipelined over `axis`.

    stage_fn(params_for_stage, microbatch) -> microbatch (same shape).
    Returns [n_micro, B_micro, ...], the LAST stage's outputs, on every
    rank of the axis."""
    n_stages = mesh_shape(mesh)[axis]
    n_micro = x.shape[0]
    stage = mesh.get_local_rank(axis)
    p = tree.map(lambda a: a[stage], stage_params)
    group = mesh.get_group(axis)
    peer = [dist.get_global_rank(group, i) for i in range(n_stages)]

    buf = torch.zeros_like(x[0])  # the microbatch currently held
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t; the others use what arrived last tick
        x_in = x[t if t < n_micro else 0] if stage == 0 else buf
        y = stage_fn(p, x_in)
        m_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and m_idx >= 0:
            outs[m_idx] = y
        if n_stages == 1:
            buf = y
            continue
        # forward y to the next stage, receive from the previous one
        buf = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), peer[(stage + 1) % n_stages], group),
               dist.P2POp(dist.irecv, buf, peer[(stage - 1) % n_stages], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # only the last stage holds the outputs: broadcast them to every stage
    # (JAX sums zeros from the other stages, the same values)
    if n_stages > 1:
        dist.broadcast(outs, src=peer[n_stages - 1], group=group)
    return outs
