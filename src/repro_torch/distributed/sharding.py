"""Sharding rules (port of ``repro/distributed/sharding.py``): parameter-name
patterns -> partition specs, the mesh context the model code consults, and
the local shards a rank holds.

Axis conventions (``launch/mesh.py``):
  single pod:  (data=16, model=16)            axes ("data", "model")
  multi-pod:   (pod=2, data=16, model=16)     axes ("pod", "data", "model")
The batch shards over ("pod", "data") when present; tensor / expert
parallelism over "model".  Under the FSDP/ZeRO-3 mapping (``set_mesh(mesh,
data_only=True)``) the batch shards over every axis and the weights stay
2-D sharded by the rules.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (one rank per
device); the rule functions read only its axis names and sizes
(:func:`mesh_shape`).  A spec is a :class:`P`, a tuple with
``PartitionSpec``'s equality: one entry per tensor dim, ``None``, an axis
name, or a tuple of axis names listed major to minor.  A
:class:`NamedSharding` maps a spec onto a mesh: the block a rank holds
(:meth:`NamedSharding.index`), that block cut from a full tensor
(:func:`shard_local`), the full tensor gathered back from the blocks
(:func:`gather`), and the same layout as DTensor placements
(:meth:`NamedSharding.placements`).

The JAX package annotates activations with ``with_sharding_constraint`` and
lets XLA partition the program.  The port runs the partitioned program by
hand: each rank computes on its own rows of the batch, so :func:`shard`
resolves and validates the constraint and returns its input; a weight is
gathered from its blocks where it is used (:func:`gather_weight`: ``dense``,
the embedding lookup, the loss's unembedding), per layer for a stacked leaf
(:func:`unbind`, :func:`take`), and the gather's backward sums the ranks'
gradients and keeps this rank's block, as XLA's transpose of the gather does.

Under the tensor-parallel (TP) mapping (``set_mesh(mesh)`` without
``data_only``) the batch splits over the batch axes (``("pod", "data")``)
and the model code chooses its collectives itself.  A layer computes split
over ``model`` only where the model axis divides what it splits
(:func:`model_splits`: the kv heads, the MLP's F, the experts or else their
F, the vocab); its weights come as this rank's ``model`` block
(:func:`gather_weight` keeps the stored model block; :func:`model_block`
cuts one along any dim), its input passes :func:`model_enter` (identity
forward, all-reduce over ``model`` backward) and a row-split product's
partial sums :func:`model_reduce` (all-reduce forward, identity backward):
Megatron's f and g.  Every other layer gathers its weights whole
(:func:`gather_whole`) and runs on every model rank.  Each gather's backward
sums the gradient over the batch axes (and over ``model`` where the ranks
held different pieces) and keeps this rank's stored block.  Collectives over
an axis of size 1 are skipped, so on a 1 x 1 mesh every gather, f and g is
the tensor itself.
"""
from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import Any, Optional

import torch


class P(tuple):
    """The port's ``PartitionSpec``: ``P("data", None)`` equals
    ``P("data", None)`` and unpacks like the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or of anything with
    ``jax.sharding.Mesh``'s ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


_ACTIVE_MESH = None
_DATA_ONLY = False  # FSDP/ZeRO mapping: every mesh axis is a batch axis
_WHOLE_BATCH = False  # the activations hold every row (whole_batch())


def set_mesh(mesh, data_only: bool = False) -> None:
    """Installs the mesh the model code consults (``None`` removes it).

    data_only=True selects the FSDP/ZeRO-3 mapping: the batch shards over
    ALL mesh axes and no tensor parallelism is requested; the weights stay
    2-D sharded by the param rules and are gathered where they are used."""
    global _ACTIVE_MESH, _DATA_ONLY
    _ACTIVE_MESH = mesh
    _DATA_ONLY = data_only


@contextlib.contextmanager
def use_mesh(mesh, data_only: bool = False):
    """``set_mesh`` for the block; the mesh before it is restored after."""
    prev = (_ACTIVE_MESH, _DATA_ONLY)
    set_mesh(mesh, data_only)
    try:
        yield mesh
    finally:
        set_mesh(*prev)


@contextlib.contextmanager
def whole_batch():
    """For the block, the model code's activations hold every row of the
    batch on every rank (a serving wave whose size the batch ranks do not
    divide: JAX's ``validate_spec`` drops the batch axis there), so the
    batch statistics (:func:`batch_ranks`, :func:`batch_all_gather`, ...)
    span one rank."""
    global _WHOLE_BATCH
    prev, _WHOLE_BATCH = _WHOLE_BATCH, True
    try:
        yield
    finally:
        _WHOLE_BATCH = prev


def get_mesh():
    return _ACTIVE_MESH


def data_only() -> bool:
    return _ACTIVE_MESH is not None and _DATA_ONLY


def batch_axes() -> tuple[str, ...]:
    if _ACTIVE_MESH is None:
        return ()
    names = tuple(mesh_shape(_ACTIVE_MESH))
    if _DATA_ONLY:
        return names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis() -> Optional[str]:
    if _ACTIVE_MESH is None or _DATA_ONLY:
        return None
    if "model" in mesh_shape(_ACTIVE_MESH):
        return "model"
    return None


def tp_active() -> bool:
    """Whether the TP mapping is installed (a mesh, not ``data_only``)."""
    return _ACTIVE_MESH is not None and not _DATA_ONLY


def mapping_of(mesh) -> str:
    """The mapping a mesh step over ``mesh`` runs: ``"tp"`` when
    ``set_mesh(mesh)`` installed it, else ``"fsdp"`` (``set_mesh(mesh,
    data_only=True)``, or no mapping installed, the default)."""
    return "tp" if _ACTIVE_MESH is mesh and not _DATA_ONLY else "fsdp"


def model_size() -> int:
    """The model axis's size under the TP mapping, else 1."""
    ax = model_axis()
    return mesh_shape(_ACTIVE_MESH)[ax] if ax is not None else 1


def model_rank() -> int:
    ax = model_axis()
    return _ACTIVE_MESH.get_local_rank(ax) if ax is not None and model_size() > 1 else 0


def model_splits(n: int) -> bool:
    """The rule of a hand-partitioned TP layer: it splits ``n`` (kv heads,
    F, experts, vocab) over ``model`` only under the TP mapping and only
    where the model axis divides ``n``."""
    return tp_active() and model_axis() is not None and n % model_size() == 0


_LOGGED: set = set()


def log_branch(kind: str, split: bool, n: int, why: Optional[str] = None) -> None:
    """Logs (logger ``repro_torch.tp``), once per layer kind and mesh,
    which branch a TP layer took."""
    if not tp_active():
        return
    key = (id(_ACTIVE_MESH), kind, split)
    if key in _LOGGED:
        return
    _LOGGED.add(key)
    import logging

    how = f"split over model ({n} / {model_size()})" if split else \
        f"whole on every model rank ({why or f'{n} not divisible by {model_size()}'})"
    logging.getLogger("repro_torch.tp").info("%s: %s", kind, how)


def _axis_groups(axes) -> list:
    """(group, size) of each named axis of the active mesh with more than
    one rank, major to minor."""
    sizes = mesh_shape(_ACTIVE_MESH)
    return [(_ACTIVE_MESH.get_group(a), sizes[a]) for a in axes if sizes.get(a, 1) > 1]


def _all_reduce(t: torch.Tensor, axes, op=None) -> torch.Tensor:
    """``t`` reduced in place over ``axes`` of the active mesh."""
    import torch.distributed as dist

    for group, _ in _axis_groups(axes):
        if op is None:
            dist.all_reduce(t, group=group)
        else:
            dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of ``t`` along ``dim`` over ``axes`` (major to minor),
    concatenated in mesh order."""
    import torch.distributed as dist

    out = t
    for group, size in reversed(_axis_groups(axes)):
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
    return out


def _row_axes() -> tuple[str, ...]:
    """The axes the activations' rows are split over: the batch axes,
    none inside :func:`whole_batch`."""
    return () if _WHOLE_BATCH else batch_axes()


def batch_ranks() -> int:
    """The ranks the batch's rows split over (the product of the batch
    axes; 1 inside :func:`whole_batch`)."""
    if _ACTIVE_MESH is None:
        return 1
    sizes = mesh_shape(_ACTIVE_MESH)
    return math.prod(sizes[a] for a in _row_axes())


def batch_rank() -> int:
    """This rank's block of the batch, counted major to minor."""
    if _ACTIVE_MESH is None:
        return 0
    sizes = mesh_shape(_ACTIVE_MESH)
    coord = dict(zip(sizes, _ACTIVE_MESH.get_coordinate()))
    r = 0
    for a in _row_axes():
        r = r * sizes[a] + coord[a]
    return r


def batch_rows(n: int) -> slice:
    """This rank's rows of a batch of ``n`` under the active mapping: its
    block where the batch ranks divide ``n``, else all of them (JAX's
    ``validate_spec`` drops an axis that does not divide)."""
    k = batch_ranks()
    if k == 1 or n % k:
        return slice(0, n)
    r = batch_rank()
    return slice(r * (n // k), (r + 1) * (n // k))


def batch_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in place over the batch ranks."""
    return _all_reduce(t, _row_axes()) if _ACTIVE_MESH is not None else t


def batch_all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every batch rank's ``t`` concatenated along ``dim``, in batch order."""
    return _all_gather(t, _row_axes(), dim) if _ACTIVE_MESH is not None else t


def model_all_gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's block of ``t`` along ``dim``, in order."""
    if model_size() == 1:
        return t
    return _all_gather(t, (model_axis(),), dim % t.ndim)


def model_all_reduce(t: torch.Tensor, op=None) -> torch.Tensor:
    """``t`` reduced in place over ``model`` (no gradient)."""
    return _all_reduce(t, (model_axis(),), op) if model_size() > 1 else t


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, gradient all-reduced over model."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), (model_axis(),))


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce over model forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone(), (model_axis(),))

    @staticmethod
    def backward(ctx, grad):
        return grad


def model_enter(x: torch.Tensor) -> torch.Tensor:
    """The input of a layer split over ``model`` (f)."""
    return _Enter.apply(x) if model_size() > 1 else x


def model_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of a row-split product's partials (g)."""
    return _Reduce.apply(x) if model_size() > 1 else x


class _SumOverBatch(torch.autograd.Function):
    """A sum over the batch ranks whose gradient is summed too: the
    autograd of an all-reduce, for a statistic of the global batch that
    each rank's share of the loss uses (the MoE aux's mean gate)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone(), _row_axes())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), _row_axes())


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    return _SumOverBatch.apply(x) if batch_ranks() > 1 else x


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """The activation constraint under the active mesh; ``x`` itself.

    spec entries: "batch" (expands to the batch axes tuple), "model", or
    None.  The spec is resolved and validated as the JAX function does; a
    rank's activations already are its block (its own rows), so nothing
    moves."""
    if _ACTIVE_MESH is None:
        return x
    resolved = []
    for s in spec:
        if s == "batch":
            ax = batch_axes()
            resolved.append(ax if ax else None)
        elif s == "model":
            resolved.append(model_axis())
        else:
            resolved.append(s)
    validate_spec(P(*resolved), tuple(x.shape), _ACTIVE_MESH)
    return x


def gather_weight(w):
    """Under the FSDP/ZeRO-3 mapping, the full weight from its blocks,
    gathered BEFORE any dtype conversion (the wire carries bf16 / int8
    payloads, not f32): a block that :func:`shard_local` or :func:`unbind`
    cut is gathered over the mesh, differentiably (:class:`_GatherBlocks`);
    a full tensor, or a block that is the whole tensor (every sharding axis
    of size 1), is returned as it is.  A quantized dict gathers its
    ``data`` and ``scale``.

    Under the TP mapping, the weight gathered over every axis but
    ``model``: this rank's stored model block (:class:`_GatherTP`)."""
    if _ACTIVE_MESH is None:
        return w
    if isinstance(w, dict):  # quantized payload
        out = dict(w)
        for k in ("data", "scale"):
            if k in out:
                out[k] = gather_weight(out[k])
        return out
    sh = getattr(w, "_mesh_sharding", None)
    if not _DATA_ONLY:
        return _tp_gather(w, model_dim(w))
    return w if sh is None or not moves(sh) else _GatherBlocks.apply(w, sh)


def gather_whole(w):
    """The whole weight under either mapping (under FSDP,
    :func:`gather_weight`): for a layer that runs whole on every model
    rank."""
    if _ACTIVE_MESH is None or _DATA_ONLY:
        return gather_weight(w)
    if isinstance(w, dict):
        return {**w, **{k: gather_whole(w[k]) for k in ("data", "scale") if k in w}}
    return _tp_gather(w, None)


def model_block(w, dim: int):
    """Under the TP mapping, this rank's ``model`` block of the weight
    along ``dim`` (the stored block where the model axis lies on ``dim``,
    else cut from the whole weight).  A quantized dict's ``scale`` is cut
    along the same dim, except along K (dim -2), where it has size 1 and
    stays whole: each rank scales its partial sums by the whole column
    scale, which is linear, so the partials still sum to the product."""
    if isinstance(w, dict):
        nd = w["data"].ndim
        d = dim % nd
        out = {**w, "data": model_block(w["data"], d)}
        if "scale" in w:
            out["scale"] = (gather_whole(w["scale"]) if d == nd - 2
                            else model_block(w["scale"], d))
        return out
    return _tp_gather(w, dim % w.ndim)


def full_shape(w) -> tuple[int, ...]:
    """The shape of the whole weight (a block's global shape)."""
    sh = getattr(w, "_mesh_sharding", None)
    return tuple(w.shape) if sh is None else sh.global_shape(tuple(w.shape))


def model_dim(w) -> Optional[int]:
    """The dim of ``w`` (of a quantized dict's ``data``) that its stored
    sharding splits over ``model`` alone, or None."""
    if isinstance(w, dict):
        return model_dim(w["data"])
    sh = getattr(w, "_mesh_sharding", None)
    if sh is None:
        return None
    for d, axes in enumerate(sh._dims(w.ndim)):
        if "model" in axes:
            return d if axes == ("model",) else None
    return None


def _tp_gather(w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``w`` gathered under the TP mapping: whole (``dim`` None), or this
    rank's model block along ``dim``."""
    sh = getattr(w, "_mesh_sharding", None)
    if mesh_size(_ACTIVE_MESH) == 1:
        return w
    if sh is None:  # the same full tensor on every rank: cut, no reduction backward
        if dim is None or model_size() == 1:
            return w
        n = w.shape[dim] // model_size()
        return w.narrow(dim, model_rank() * n, n)
    return _GatherTP.apply(w, sh, dim)


class _GatherTP(torch.autograd.Function):
    """The TP mapping's gather of a stored block: forward, every axis but
    ``model`` where the wanted block is the stored model block, else every
    axis and then the rank's model block along ``dim`` (or the whole
    weight).  Backward: the gradient of the piece summed over the batch
    axes (each batch rank saw its own rows), and over ``model`` where the
    model ranks held different pieces of the weight; this rank's stored
    block of the sum."""

    @staticmethod
    def forward(ctx, block, sharding, dim):
        keep = dim is not None and model_dim(block) == dim
        ctx.sharding, ctx.dim, ctx.keep = sharding, dim, keep
        ctx.full_shape = sharding.global_shape(tuple(block.shape))
        out = gather(block, sharding, skip=("model",) if keep else ())
        if dim is not None and not keep:
            n = out.shape[dim] // model_size()
            out = out.narrow(dim, model_rank() * n, n).contiguous()
        return out.view_as(out) if out is block else out

    @staticmethod
    def backward(ctx, grad):
        s, dim, shape = ctx.sharding, ctx.dim, ctx.full_shape
        idx = list(s.index(shape))
        if ctx.keep:  # the piece is the stored model block: rows' sums only
            g = _all_reduce(grad.contiguous().clone(), batch_axes())
            idx[dim] = slice(None)
            return g[tuple(idx)].contiguous(), None, None
        if dim is None:  # every model rank computed the same whole gradient
            full = _all_reduce(grad.contiguous().clone(), batch_axes())
        else:
            full = grad.new_zeros(shape)
            n = shape[dim] // model_size()
            full.narrow(dim, model_rank() * n, n).copy_(grad)
            full = _all_reduce(full, batch_axes() + (model_axis(),))
        return full[tuple(idx)].contiguous(), None, None


class _GatherBlocks(torch.autograd.Function):
    """:func:`gather` with a backward: each rank's gradient of the full
    tensor is its share of the loss's, so the backward sums them over the
    mesh and keeps this rank's block."""

    @staticmethod
    def forward(ctx, block, sharding):
        ctx.sharding = sharding
        return gather(block, sharding)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.sharding
        full = mesh_all_reduce(grad.contiguous().clone(), s.mesh)
        return full[s.index(tuple(full.shape))].contiguous(), None


def _child(s: NamedSharding) -> NamedSharding:
    """A stacked leaf's sharding without its layer dim."""
    if s.spec and s.spec[0] is not None:
        raise ValueError(f"a stacked leaf sharded over its layer dim: {s.spec}")
    return NamedSharding(s.mesh, P(*tuple(s.spec)[1:]))


def unbind(leaf: torch.Tensor) -> tuple:
    """``leaf.unbind(0)`` (a stacked leaf's layers); a block's layers are
    blocks under its spec without the layer dim, gathered where used."""
    s = getattr(leaf, "_mesh_sharding", None)
    parts = leaf.unbind(0)
    if s is not None:
        child = _child(s)
        for part in parts:
            part._mesh_sharding = child
    return parts


def take(leaf: torch.Tensor, i: int) -> torch.Tensor:
    """``leaf[i]``, a stacked leaf's layer ``i`` (a view), which remembers
    the block's sharding without the layer dim, as :func:`unbind` does."""
    part = leaf[i]
    s = getattr(leaf, "_mesh_sharding", None)
    if s is not None:
        part._mesh_sharding = _child(s)
    return part


# --------------------------------------------------------------- parameters
# Pattern rules, first match wins; each pattern lists CANDIDATE specs and the
# first (after divisibility validation) with the largest sharding factor wins.
# Weights shard 2-D: tensor-parallel over "model" AND FSDP/ZeRO-style over
# "data" (grads + optimizer states inherit the same specs).  Stacked layer
# params get a leading None automatically.  (The JAX package's table.)
_RULES: list[tuple[str, list[tuple] | None]] = [
    (r"(^|/)embed$", [("model", "data")]),  # [V, D]
    (r"unembed$", [("data", "model")]),  # [D, V]
    (r"(wq|wk|wv)$", [("data", "model")]),  # [D, H*hd]
    (r"wo$", [("model", "data")]),  # [H*hd, D]
    (r"router$", [(None, None)]),  # small, replicated
    # MoE experts [E, D, F] / [E, F, D]: experts over model when divisible,
    # otherwise fall back to sharding the matrix dims (mixtral has E=8 < 16)
    (r"moe/(wg|wu|wd)$", [("model", "data", None), (None, "data", "model")]),
    (r"mlp/(wg|wu)$", [("data", "model")]),  # [D, F]
    (r"mlp/wd$", [("model", "data")]),  # [F, D]
    (r"in_proj$", [("data", "model")]),  # ssm fused proj (d_inner sharded)
    (r"out_proj$", [("model", "data")]),
    (r"(A_log|D|dt_bias)$", [(None,)]),  # tiny per-head vectors: replicated
    (r"(norm|norm1|norm2|final_norm|gamma)$", [(None,)]),
    (r"(data|scale|bits)$", None),  # quantized leaves: rule resolved by parent
]


def _pad_spec(spec: tuple, ndim: int) -> tuple:
    if len(spec) < ndim:  # stacked layers: leading layer dims replicate
        return (None,) * (ndim - len(spec)) + spec
    if len(spec) > ndim:  # e.g. packed/quantized lost a dim: trim
        return spec[-ndim:] if ndim else ()
    return spec


def _axes(ax) -> tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _shard_factor(spec: P, mesh) -> int:
    sizes = mesh_shape(mesh)
    f = 1
    for ax in spec:
        for a in _axes(ax):
            f *= sizes[a]
    return f


def param_spec(path: str, ndim: int, shape=None, mesh=None) -> P:
    """Spec for a parameter at `path`.  With shape+mesh, candidates are
    validated for divisibility and the most-sharded survivor wins."""
    for pat, candidates in _RULES:
        if candidates is None:
            continue
        if re.search(pat, path):
            specs = [P(*_pad_spec(tuple(c), ndim)) for c in candidates]
            if shape is None or mesh is None:
                return specs[0]
            validated = [validate_spec(s, shape, mesh) for s in specs]
            return max(validated, key=lambda s: _shard_factor(s, mesh))
    return P(*([None] * ndim))


def validate_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drops mesh axes from dims they don't divide (e.g. fused projections
    whose output dim is not a multiple of the model-parallel degree) and
    axes absent from the mesh (e.g. "pod" on a single-pod mesh)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = tuple(a for a in _axes(ax) if a in sizes)
        if not axes:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in axes)
        ax_out = axes[0] if len(axes) == 1 else axes
        out.append(ax_out if dim % size == 0 else None)
    return P(*out)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` laid over ``mesh``: which block of a tensor each rank holds."""

    mesh: Any
    spec: P

    def _dims(self, ndim: int) -> list[tuple[str, ...]]:
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [_axes(ax) for ax in spec[:ndim]]

    def index(self, shape, coords=None) -> tuple[slice, ...]:
        """The block of a tensor of global ``shape`` held at mesh
        coordinates ``coords`` (default: this rank's).  Along a dim sharded
        over several axes, the block number counts them major to minor, in
        the spec's order."""
        sizes = mesh_shape(self.mesh)
        if coords is None:
            coords = self.mesh.get_coordinate()
        coord = dict(zip(sizes, coords))
        out = []
        for dim, axes in zip(shape, self._dims(len(shape))):
            n = math.prod(sizes[a] for a in axes)
            block = 0
            for a in axes:
                block = block * sizes[a] + coord[a]
            size = dim // n
            out.append(slice(block * size, (block + 1) * size))
        return tuple(out)

    def global_shape(self, local_shape) -> tuple[int, ...]:
        sizes = mesh_shape(self.mesh)
        return tuple(d * math.prod(sizes[a] for a in axes)
                     for d, axes in zip(local_shape, self._dims(len(local_shape))))

    def placements(self, ndim: int) -> list:
        """The same layout as DTensor placements, one per mesh dim.  DTensor
        splits a dim sharded over several mesh dims in mesh-dim order, so a
        spec that lists them in another order has no such placements
        (ValueError)."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        by_axis: dict[str, int] = {}
        for d, axes in enumerate(self._dims(ndim)):
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {self.spec} lists the axes of dim {d} out of the "
                                 f"mesh's order {tuple(names)}")
            for a in axes:
                by_axis[a] = d
        return [Shard(by_axis[a]) if a in by_axis else Replicate() for a in names]


def shard_local(t: torch.Tensor, sharding: NamedSharding, coords=None,
                device=None) -> torch.Tensor:
    """This rank's block of the full tensor ``t``, on ``device`` (default:
    ``t``'s): ``t`` itself where the block is the whole tensor (every
    sharding axis of size 1) on the same device, else a contiguous copy of
    the block alone, so the full tensor's storage is not kept alive.  The
    block remembers its sharding (:func:`gather_weight` reads it)."""
    idx = sharding.index(tuple(t.shape), coords)
    local = t if all(s == slice(0, n) for s, n in zip(idx, t.shape)) else t[idx]
    if device is not None:
        local = local.to(device)
    if local is not t:
        local = local.contiguous()
        if local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
            local = local.clone()
    local._mesh_sharding = sharding
    return local


def gather(local: torch.Tensor, sharding: NamedSharding, skip=()) -> torch.Tensor:
    """The full tensor from each rank's block, on every rank: an all-gather
    over each mesh axis that shards it (a dim's axes from minor to major),
    in the tensor's own dtype; axes named in ``skip`` stay cut.  Axes of
    size 1 move nothing: a tensor sharded only over such axes comes back as
    ``local`` itself."""
    import torch.distributed as dist

    sizes = mesh_shape(sharding.mesh)
    out = local
    for d, axes in enumerate(sharding._dims(local.ndim)):
        for a in reversed(axes):
            if sizes[a] == 1 or a in skip:
                continue
            group = sharding.mesh.get_group(a)
            parts = [torch.empty_like(out) for _ in range(sizes[a])]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, dim=d)
    return out


def moves(sharding: NamedSharding) -> bool:
    """Whether the blocks differ from the full tensor: some axis of the
    spec has more than one rank."""
    sizes = mesh_shape(sharding.mesh)
    return any(sizes[a] > 1 for ax in sharding.spec for a in _axes(ax))


def shard_factor(sharding: NamedSharding) -> int:
    """How many distinct blocks the tensor is cut into."""
    return _shard_factor(sharding.spec, sharding.mesh)


def mesh_all_reduce(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t`` summed in place over every rank of ``mesh`` (default: the
    active one): an all-reduce over each of its axes."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else _ACTIVE_MESH
    for a in mesh_shape(mesh):
        dist.all_reduce(t, group=mesh.get_group(a))
    return t


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree (dicts by key, NamedTuples by field,
    which adds nothing to the path, tuples and lists by index): the path
    strings ``jax.tree_util.tree_flatten_with_path`` gives the JAX rules."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, prefix) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def leaf_sharding(path: str, shape, mesh) -> NamedSharding:
    """The :class:`NamedSharding` the pattern rules give the leaf at
    ``path`` of global ``shape`` (None: a leaf with no shape, a quantized
    dict's ``bits``, replicated)."""
    shape = tuple(shape) if shape is not None else None
    nd = len(shape) if shape is not None else 0
    # quantized dicts: the leaf names are data/scale/bits under the
    # original weight name: reuse the parent rule for `data`.
    if path.endswith(("/data", "/scale")):
        # parent rule; size-1 dims (the scale's reduced K axis) drop in
        # validation automatically
        spec = param_spec(path.rsplit("/", 1)[0], nd, shape, mesh)
    elif path.endswith("/bits") or shape is None:
        spec = P()
    else:
        spec = param_spec(path, nd, shape, mesh)
    if shape is not None:
        spec = validate_spec(spec, shape, mesh)
    return NamedSharding(mesh, spec)


def tree_shardings(params, mesh):
    """A tree of :class:`NamedSharding` matching ``params`` (tensors or
    anything with ``shape``) via the pattern rules (:func:`leaf_sharding`)."""
    return _map_with_path(
        lambda path, leaf: leaf_sharding(path, getattr(leaf, "shape", None), mesh), params)


def dim_all_max(t: torch.Tensor, sharding: NamedSharding, dim: int, ndim: int) -> torch.Tensor:
    """``t``, a max along ``dim`` of this rank's block of an ``ndim``-dim
    tensor under ``sharding`` (or of a trailing slice of the block that
    keeps ``dim``), maxed in place over the mesh axes that split that dim:
    the max of the whole tensor."""
    import torch.distributed as dist

    sizes = mesh_shape(sharding.mesh)
    for a in sharding._dims(ndim)[dim]:
        if sizes[a] > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=sharding.mesh.get_group(a))
    return t
