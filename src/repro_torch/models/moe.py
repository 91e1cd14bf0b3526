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

Where JAX scatters with ``mode="drop"`` into a zeroed ``[E * cap, D]``
buffer, the buffer here is gathered: every slot holds at most one kept
assignment, found by a search of the sorted slots, and a slot holding none
is zero, as in JAX.  The routing's counts, its ranks and the gate weights
are sorts, searches and gathers too.  So no op of the forward scatters:
under ``torch.use_deterministic_algorithms`` (the train step's) PyTorch's
deterministic scatters read index bounds back to the host, which a CUDA
graph cannot hold, and the backward of a gather is an indexed accumulation
that reads nothing back.  Every shape follows from the input's shape
alone, and nothing is read back to the host, so a serving step or a train
step that holds this stays capturable (``serve/graphs.py``,
``train/trainer.py``).

The expert products: W4/W8 experts (a quantized dict, payload packed along
K as ``quantize_params`` packs a stacked leaf) go through ``layers.dense``
one expert at a time on its ``[cap, D]`` buffer, so through ``ops.mpmm``:
the CF dequant kernel on the card and its plain version on the CPU, as for
a dense projection; no dequantized copy of the experts is made.  Unquantized
experts are one batched ``torch.matmul``, as the JAX package leaves that
einsum to XLA.

``dispatch="alltoall"``: GShard/Switch token routing over the mesh's
``model`` axis (``_moe_ffn_alltoall``), what JAX's ``shard_map`` gives each
device.  Each rank holds its data shard's tokens (the same on every rank
of a model group), routes them with the capacity of its own token count,
sends ``[n_shards, E_loc * cap, D]`` to the experts' owners with an
all-to-all, runs its ``E / n_shards`` experts on what it received, and a
second all-to-all brings the outputs back.  The aux loss is the mean over
the data shards.  Both exchanges and the aux's sum are differentiable:
the backward of an all-to-all is the reverse all-to-all over the same
group.  The gradients follow the TP mapping's convention (each rank's
loss is its share, the data shards' shares sum to the loss, and the model
ranks hold copies of it): x and the router get this shard's gradient as
they are.  Every expert receives ``n_shards`` copies of a token, one from
each model rank, each with the full cotangent, so its weights' gradient
is divided by ``n_shards``: JAX's transpose of the ``shard_map`` divides
the outputs' cotangent by the model axis's size and sums the inputs' over
it, which comes to the same.  With no mapping installed the expert leaves
are full tensors (each rank slices its experts); under the TP mapping they
are the stored blocks of E over ``model`` (``sharding.model_block``,
whose backward sums over the batch ranks).  ``x`` must be this rank's
data shard: a batch the data shards do not divide is the caller's to
refuse (the static-wave ``Server`` raises), as the ``shard_map`` refuses it.

Under the TP mapping (``sharding.set_mesh(mesh)``) the replicated dispatch
runs on this rank's rows of the batch (``_moe_ffn_replicated``).  Routing and
capacity are global, as under SPMD: the top-k ids of every batch rank are
gathered (T x k int32), the capacity and every assignment's slot come from
the global order, and each rank keeps its own tokens' slots, so the same
assignments drop as in the unsharded function; the aux is the global
batch's (counts over the gathered ids, the gate's mean summed over the
batch ranks), the same on every rank.  Where the model axis divides the
experts, each model rank runs its E / M experts on its tokens' slots in
them, and the combine sums every rank's own experts' contributions over
``model``; else, where it divides F, every rank runs every expert on its
block of F (``wg`` / ``wu`` columns, ``wd`` rows) and the expert outputs
are summed over ``model``; else the experts run whole on every model rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers import dense, dense_init


def _positions_in_expert(eids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Flat expert assignments [T*k] -> each one's rank among the
    assignments to its expert, in token order [T*k] int32."""
    tk = eids.shape[0]
    order = torch.argsort(eids, stable=True)
    sorted_e = eids[order].contiguous()
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(tk, device=eids.device) - first
    # back to token order through the inverse permutation (a gather)
    return ranks[torch.argsort(order)].to(torch.int32)


def _expert_counts(flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Flat expert assignments [T*k] -> the assignments each expert got,
    [E] f32 (exact integers), from the sorted ids."""
    sorted_e = torch.sort(flat).values.contiguous()
    edges = torch.arange(n_experts + 1, dtype=sorted_e.dtype, device=flat.device)
    bounds = torch.searchsorted(sorted_e, edges, side="left")
    return (bounds[1:] - bounds[:-1]).float()


def _route(x2: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x2 [T, D] -> (weights [T, k] f32, eids [T, k] int32, aux loss, probs
    [T, E])."""
    logits = x2.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    eids = torch.topk(probs.detach(), top_k, dim=-1).indices
    # the top-k values gathered by index (their gradient an indexed
    # accumulation, not topk's scatter; see the module note)
    rows = torch.arange(probs.shape[0], device=probs.device)[:, None]
    weights = probs[rows, eids]
    weights = weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style load-balance aux: E * sum_e (frac_tokens_e * mean_prob_e)
    e = probs.shape[-1]
    counts = _expert_counts(eids.reshape(-1), e)
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
    return _moe_ffn_replicated(x, params, top_k, capacity_factor)


def _capacity(n_tokens: int, top_k: int, capacity_factor: float, e: int) -> int:
    """Slots per expert for ``n_tokens`` tokens routed ``top_k`` ways."""
    return int(max(1, (n_tokens * top_k * capacity_factor) // e))


def _dispatch(x2: torch.Tensor, eids: torch.Tensor, pos: torch.Tensor, cap: int,
              lo: int, n_exp: int):
    """Fill the buffers of experts ``[lo, lo + n_exp)`` with the tokens x2
    [T, D] routed there: ``eids`` [T, k] their experts, ``pos`` [T, k] their
    slots in them, an assignment at ``pos >= cap`` dropped -> (buf [n_exp *
    cap, D], slot [T * k], own [T, k]: the assignments kept in these
    experts)."""
    n_slots, k = n_exp * cap, eids.shape[1]
    own = (pos < cap) & (eids >= lo) & (eids < lo + n_exp)
    slot = torch.where(own, (eids - lo) * cap + pos, 0).reshape(-1).long()
    # each slot's kept assignment: a search of the kept slots, sorted (the
    # others sort past the end); a slot no assignment fills stays zero.  The
    # rows come from the assignments' [T*k, D] copies of their tokens, so
    # each kept row's gradient lands on its own row (no two sum there), and
    # the k copies of a token sum as a reduction.
    key = torch.where(own.reshape(-1), slot, n_slots)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order].contiguous()
    at = torch.searchsorted(sorted_key, torch.arange(n_slots, device=key.device))
    at = at.clamp_max(key.shape[0] - 1)
    filled = sorted_key[at] == torch.arange(n_slots, device=key.device)
    rows = x2[:, None, :].expand(-1, k, -1).reshape(-1, x2.shape[-1])
    buf = torch.where(filled[:, None], rows[order[at]], 0)
    return buf, slot, own


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, own: torch.Tensor,
             weights: torch.Tensor, dtype) -> torch.Tensor:
    """The experts' outputs [n_exp * cap, D] back to the tokens: each kept
    assignment's slot, weighted by its gate -> [T, D] in ``dtype``."""
    t, k = own.shape
    got = out_buf[slot].reshape(t, k, out_buf.shape[-1])
    got = torch.where(own[..., None], got, 0)
    return torch.sum(got * weights[..., None].to(dtype), dim=1)


def _moe_ffn_replicated(x: torch.Tensor, params: dict, top_k: int,
                        capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The replicated dispatch, unsharded or under the TP mapping (see the
    module note).  With no mesh it takes the last branch, every expert whole
    on the batch's tokens; on a 1 x 1 mesh the expert-split branch, which
    there is the same computation op for op."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    f = sharding.full_shape(params["wg"]["data"] if isinstance(params["wg"], dict)
                            else params["wg"])[-1]
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    weights, eids, aux, probs = _route(x2, params["router"], top_k)
    n_b = sharding.batch_ranks()
    eids_all = eids
    if n_b > 1:  # global routing order: every batch rank's ids, in batch order
        eids_all = sharding.batch_all_gather(eids)
        flat = eids_all.reshape(-1)
        counts = _expert_counts(flat, e)
        frac = counts / torch.clamp_min(counts.sum(), 1.0)
        mean_p = sharding.batch_sum(probs.sum(dim=0)) / eids_all.shape[0]
        aux = e * torch.sum(frac * mean_p)
    n_all = eids_all.shape[0]
    cap = _capacity(n_all, top_k, capacity_factor, e)
    lo_t = sharding.batch_rank() * t if n_b > 1 else 0
    pos = _positions_in_expert(eids_all.reshape(-1), e).reshape(n_all, top_k)[lo_t:lo_t + t]
    ep = sharding.model_splits(e)
    fsplit = not ep and sharding.model_splits(f)
    sharding.log_branch("moe experts", ep, e)
    if not ep:
        sharding.log_branch("moe expert F", fsplit, f)
    lo, n_exp = 0, e
    if ep:  # this rank's E / M experts
        n_exp = e // sharding.model_size()
        lo = sharding.model_rank() * n_exp
        ws = [sharding.model_block(params[k], 0) for k in ("wg", "wu", "wd")]
    elif fsplit:  # every expert on this rank's block of F
        ws = [sharding.model_block(params["wg"], -1), sharding.model_block(params["wu"], -1),
              sharding.model_block(params["wd"], -2)]
    else:
        ws = [sharding.gather_whole(params[k]) for k in ("wg", "wu", "wd")]
    xe = sharding.model_enter(x2) if ep or fsplit else x2
    buf, slot, own = _dispatch(xe, eids, pos, cap, lo, n_exp)
    out_buf = _expert_ffn(buf.reshape(n_exp, cap, d), *ws).reshape(n_exp * cap, d)
    if fsplit:  # each rank's F block's share of every expert's output
        out_buf = sharding.model_reduce(out_buf)
    out = _combine(out_buf, slot, own, sharding.model_enter(weights) if ep else weights,
                   x.dtype)
    if ep:  # each rank's own experts' contributions
        out = sharding.model_reduce(out)
    return out.reshape(b, s, d), aux.float()


def _local_experts(w, e: int, lo: int, hi: int):
    """Experts [lo, hi) of a stacked expert leaf (a plain tensor or a
    quantized dict); a leaf that holds E / n_shards experts already is this
    rank's own."""
    if isinstance(w, dict):
        if w["data"].shape[0] != e:
            return w
        return {**w, "data": w["data"][lo:hi], "scale": w["scale"][lo:hi]}
    return w[lo:hi] if w.shape[0] == e else w


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of ``x`` [n, ...] to rank i of ``group``; block i of the
    result from rank i."""
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` whose gradient is the reverse exchange (the same
    all-to-all: block i of rank r's gradient goes back to rank i)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _SumOver(torch.autograd.Function):
    """A sum over ``groups`` whose gradient is summed over them too."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_over(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.groups), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _moe_ffn_alltoall(x: torch.Tensor, params: dict, *, top_k: int, capacity_factor: float,
                      axis: str, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style token routing over ``axis`` (see the module note)."""
    mesh = mesh if mesh is not None else sharding.get_mesh()
    if mesh is None:
        raise ValueError("moe_dispatch='alltoall' needs a device mesh")
    sizes = sharding.mesh_shape(mesh)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    n_shards = sizes[axis]
    if e % n_shards:
        raise ValueError(f"{e} experts do not divide over {n_shards} {axis!r} shards")
    data_axes = [a for a in sizes if a != axis and sizes[a] > 1]
    n_data = math.prod(sizes[a] for a in data_axes)
    e_loc = e // n_shards
    me = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    weights, eids, aux, _ = _route(x2, params["router"], top_k)
    cap = _capacity(t, top_k, capacity_factor, e)
    pos = _positions_in_expert(eids.reshape(-1), e).reshape(t, top_k)
    buf, flat_slot, keep = _dispatch(x2, eids, pos, cap, 0, e)
    # [n_shards, e_loc * cap, d] -> all-to-all: shard i keeps its experts'
    # buffers from every peer
    recv = _AllToAll.apply(buf.reshape(n_shards, e_loc * cap, d), group)
    # [peers, e_loc * cap, d] -> merge the token sets per expert
    recv = recv.reshape(n_shards, e_loc, cap, d).transpose(0, 1).reshape(e_loc, n_shards * cap, d)
    if sharding.tp_active():  # this rank's stored blocks of E, gathered over the batch axes
        ws = [sharding.model_block(params[k], 0) for k in ("wg", "wu", "wd")]
    else:
        ws = [_local_experts(params[k], e, me * e_loc, (me + 1) * e_loc)
              for k in ("wg", "wu", "wd")]
    if n_shards > 1:  # each of the n_shards copies of a token brings its full cotangent
        ws = [w if isinstance(w, dict) else _ScaleGrad.apply(w, 1.0 / n_shards) for w in ws]
    out_buf = _expert_ffn(recv, *ws)
    out_buf = out_buf.reshape(e_loc, n_shards, cap, d).transpose(0, 1)
    back = _AllToAll.apply(out_buf.reshape(n_shards, e_loc * cap, d), group)
    out = _combine(back.reshape(e * cap, d), flat_slot, keep, weights, x.dtype)
    # aux differs per data shard: its mean over them
    aux = aux.float()
    if n_data > 1:
        aux = _SumOver.apply(aux, [mesh.get_group(a) for a in data_axes]) / n_data
    return out.reshape(b, s, d), aux


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
