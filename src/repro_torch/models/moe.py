"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): the replicated
dispatch and the all-to-all one.

Routing: an f32 softmax gate, top-k, weights renormalised over the k picks,
and the Switch load-balancing auxiliary loss.  Dispatch: every expert gets a
buffer of ``cap = max(1, (T * top_k * capacity_factor) // E)`` token slots;
a token's slot in its expert is its rank among the tokens routed there (a
stable sort of the flat assignments, then ``searchsorted``: no [T, E]
one-hot), and assignments ranked past ``cap`` are dropped.  The same
capacity, the same dropped tokens and the same slot for every kept token as
the JAX function, bit for bit.

Where JAX scatters with ``mode="drop"``, the buffer here is an
``index_add_`` onto a zeroed ``[E * cap, D]`` tensor: a dropped assignment
adds a zero row to slot 0, as in JAX, and every slot receives at most one
nonzero row, so the result does not depend on the order of the adds.  Every
shape follows from the input's shape alone, and nothing is read back to the
host, so a serving step that holds this stays capturable
(``serve/graphs.py``).

The expert products: W4/W8 experts (a quantized dict, payload packed along
K as ``quantize_params`` packs a stacked leaf) go through ``layers.dense``
one expert at a time on its ``[cap, D]`` buffer, so through ``ops.mpmm``:
the CF dequant kernel on the card and its plain version on the CPU, as for
a dense projection; no dequantized copy of the experts is made.  Unquantized
experts are one batched ``torch.matmul``, as the JAX package leaves that
einsum to XLA.

``dispatch="alltoall"``: GShard/Switch token routing over the mesh's
``model`` axis (``_moe_ffn_alltoall``).  Each rank holds its data shard's
tokens (the same on every rank of a model group), routes them with the
capacity of its own token count, sends ``[n_shards, E_loc * cap, D]`` to
the experts' owners with ``all_to_all_single``, runs its ``E / n_shards``
experts on what it received, and a second all-to-all brings the outputs
back.  The aux loss is the mean over the data shards.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, dense_init


def _positions_in_expert(eids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Flat expert assignments [T*k] -> each one's rank among the
    assignments to its expert, in token order [T*k] int32."""
    tk = eids.shape[0]
    order = torch.argsort(eids, stable=True)
    sorted_e = eids[order].contiguous()
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(tk, device=eids.device) - first
    return torch.empty_like(ranks).scatter_(0, order, ranks).to(torch.int32)


def _route(x2: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x2 [T, D] -> (weights [T, k] f32, eids [T, k] int32, aux loss, probs
    [T, E])."""
    logits = x2.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, eids = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style load-balance aux: E * sum_e (frac_tokens_e * mean_prob_e)
    e = probs.shape[-1]
    flat = eids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=x2.device).index_add_(
        0, flat, torch.ones(flat.shape[0], dtype=torch.float32, device=x2.device))
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return weights, eids.to(torch.int32), aux, probs


def _expert(w, e: int):
    """Expert ``e``'s matrix of a stacked leaf: its own quantized dict
    (payload and per-column scale) or its plain slice."""
    if isinstance(w, dict):
        return {"data": w["data"][e], "scale": w["scale"][e], "bits": w["bits"]}
    return w[e]


def _expert_ffn(buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """Grouped SwiGLU FFN: buf [E, C, D] x w* [E, D, F] -> [E, C, D]."""
    if not isinstance(wg, dict):
        gate = torch.matmul(buf, wg.to(buf.dtype))
        up = torch.matmul(buf, wu.to(buf.dtype))
        act = F.silu(gate.float()).to(buf.dtype) * up
        return torch.matmul(act, wd.to(buf.dtype))
    out = torch.empty_like(buf)
    for e in range(buf.shape[0]):
        gate = dense(buf[e], _expert(wg, e))
        up = dense(buf[e], _expert(wu, e))
        act = F.silu(gate.float()).to(buf.dtype) * up
        out[e] = dense(act, _expert(wd, e))
    return out


def moe_ffn(
    x: torch.Tensor,  # [B, S, D]
    params: dict,  # router [D, E] f32; wg/wu [E, D, F], wd [E, F, D] (or quantized dicts)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    dispatch: str = "replicated",
    mesh=None,
    mesh_model_axis: str = "model",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B, S, D] in x.dtype, aux_loss 0-d f32).  Under
    ``dispatch="alltoall"`` ``x`` is this rank's data shard and ``mesh``
    (default: ``sharding.get_mesh()``) the DeviceMesh whose
    ``mesh_model_axis`` holds the experts."""
    if dispatch == "alltoall":
        return _moe_ffn_alltoall(x, params, top_k=top_k, capacity_factor=capacity_factor,
                                 axis=mesh_model_axis, mesh=mesh)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    buf, flat_slot, keep, weights, aux, cap = _dispatch(x2, params["router"], top_k,
                                                        capacity_factor)
    out_buf = _expert_ffn(buf.reshape(e, cap, d), params["wg"], params["wu"], params["wd"])
    gathered = out_buf.reshape(e * cap, d)[flat_slot].reshape(t, top_k, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    out = torch.sum(gathered * weights[..., None].to(x.dtype), dim=1)
    return out.reshape(b, s, d), aux.float()


def _dispatch(x2: torch.Tensor, router: torch.Tensor, top_k: int, capacity_factor: float):
    """Route the tokens x2 [T, D] and fill the per-expert buffers ->
    (buf [E * cap, D], flat_slot [T * k], keep [T, k], weights, aux, cap)."""
    t, d = x2.shape
    e = router.shape[-1]
    weights, eids, aux, _ = _route(x2, router, top_k)
    cap = int(max(1, (t * top_k * capacity_factor) // e))
    pos = _positions_in_expert(eids.reshape(-1), e).reshape(t, top_k)
    keep = pos < cap
    flat_slot = torch.where(keep, eids * cap + pos, 0).reshape(-1).long()
    contrib = torch.where(keep[..., None], x2[:, None, :], 0).reshape(-1, d)
    buf = x2.new_zeros(e * cap, d).index_add_(0, flat_slot, contrib)
    return buf, flat_slot, keep, weights, aux, cap


def _local_experts(w, e: int, lo: int, hi: int):
    """Experts [lo, hi) of a stacked expert leaf (a plain tensor or a
    quantized dict); a leaf that holds E / n_shards experts already is this
    rank's own."""
    if isinstance(w, dict):
        if w["data"].shape[0] != e:
            return w
        return {**w, "data": w["data"][lo:hi], "scale": w["scale"][lo:hi]}
    return w[lo:hi] if w.shape[0] == e else w


def _moe_ffn_alltoall(x: torch.Tensor, params: dict, *, top_k: int, capacity_factor: float,
                      axis: str, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style token routing over ``axis`` (see the module note)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding

    mesh = mesh if mesh is not None else sharding.get_mesh()
    if mesh is None:
        raise ValueError("moe_dispatch='alltoall' needs a device mesh")
    sizes = sharding.mesh_shape(mesh)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    n_shards = sizes[axis]
    if e % n_shards:
        raise ValueError(f"{e} experts do not divide over {n_shards} {axis!r} shards")
    e_loc = e // n_shards
    me = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    buf, flat_slot, keep, weights, aux, cap = _dispatch(x2, params["router"], top_k,
                                                        capacity_factor)
    # [n_shards, e_loc * cap, d] -> all-to-all: shard i keeps its experts'
    # buffers from every peer
    buf = buf.reshape(n_shards, e_loc * cap, d)
    recv = torch.empty_like(buf)
    dist.all_to_all_single(recv, buf, group=group)
    # [peers, e_loc * cap, d] -> merge the token sets per expert
    recv = recv.reshape(n_shards, e_loc, cap, d).transpose(0, 1).reshape(e_loc, n_shards * cap, d)
    lo, hi = me * e_loc, (me + 1) * e_loc
    out_buf = _expert_ffn(recv, *(_local_experts(params[k], e, lo, hi)
                                  for k in ("wg", "wu", "wd")))
    out_buf = out_buf.reshape(e_loc, n_shards, cap, d).transpose(0, 1)
    back = torch.empty_like(buf)
    dist.all_to_all_single(back, out_buf.reshape(n_shards, e_loc * cap, d).contiguous(),
                           group=group)
    out_flat = back.reshape(e * cap, d)[flat_slot].reshape(t, top_k, d)
    out_flat = torch.where(keep[..., None], out_flat, 0)
    out = torch.sum(out_flat * weights[..., None].to(x.dtype), dim=1)
    # aux differs per data shard: its mean over them
    aux = aux.float().clone()
    n_data = 1
    for a, size in sizes.items():
        if a != axis:
            dist.all_reduce(aux, group=mesh.get_group(a))
            n_data *= size
    return out.reshape(b, s, d), aux / n_data


def init_moe_params(gen: torch.Generator, d: int, d_ff: int, n_experts: int, dtype,
                    *lead: int) -> dict:
    """Random router and experts on ``gen.device``, stacked over ``lead``
    (layers): router N(0, 1/d) f32 [*lead, D, E]; wg, wu N(0, 1/d) [*lead, E,
    D, F]; wd N(0, 1/F) [*lead, E, F, D].  Each expert's matrix is drawn in
    f32 on its own (``dense_init``), so a full-width stack never needs an f32
    copy of a layer's experts."""
    router = torch.randn((*lead, d, n_experts), generator=gen, device=gen.device)
    return {
        "router": router * (1.0 / math.sqrt(d)),
        "wg": dense_init(gen, d, d_ff, dtype, *lead, n_experts),
        "wu": dense_init(gen, d, d_ff, dtype, *lead, n_experts),
        "wd": dense_init(gen, d_ff, d, dtype, *lead, n_experts),
    }
