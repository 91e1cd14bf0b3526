"""Training loop (port of ``repro/train/trainer.py``): a train step with
gradient accumulation, global-norm clipping and the LR schedule; async
checkpointing, straggler monitoring and crash-resume.

Where JAX maps a function over the whole tree, the step works leaf by leaf
and in place, with the same arithmetic: the clip scales each gradient in
place, and ``Optimizer.apply`` writes the new params and state (its step
counter too) into the old tensors.  So at llama3.2-3b's width no tree-wide
f32 copy of the gradients (14.4 GB) or update tree (7.2 GB) joins the 43.3
GB of bf16 params and grads and f32 m and v.

The captured step, the counterpart of JAX's ``jax.jit(step_fn,
donate_argnums=(0, 1))``: without a mesh, ``Trainer`` runs every step
through ``serve/graphs.py``'s ``StepGraphs`` (``Trainer.graphs``).  Its
inputs are static buffers the Trainer owns, refilled before each step: the
batch's tensors by ``copy_`` and the step, a 0-d int32 tensor on the
device, by ``fill_``, from which the step computes its lr on the device
(``optim/schedules.py``).  Its params and optimizer state are the graph's
own storage, updated in place (the counterpart of donation): a Trainer
keeps the tensors of its first run, and a later ``run()`` (a restore, as
``run_with_restarts`` makes one, or a fresh start) writes its starting
state into them, so the tensors a run returns are those the next run
overwrites.  On the card the first step of a Trainer runs eagerly (the
warm-up, a real step) and the step is then captured as one
``torch.cuda.CUDAGraph``: forward and backward, microbatches included, the
global-norm clip and the optimizer's in-place ``apply``; every later step is
a copy-in and a replay.  On the CPU, and under ``graphs.disable_capture()``
(the counterpart of ``jax.disable_jit()``), the same function runs eagerly
on the same buffers.  Nothing in the step reads the card back: the remat
and cross-entropy checkpoints keep no RNG state, the cross-entropy and the
MoE routing gather instead of scattering (``models/layers.py``,
``models/moe.py``).  The mesh steps (FSDP, TP) stay eager: their
collectives would sit inside the graph, and no world above one rank can
hold one here.

On a device mesh (``Trainer(mesh=...)``, ``make_train_step(..., mesh=)``)
the step is the JAX package's FSDP/ZeRO-3 mapping
(``sharding.set_mesh(mesh, data_only=True)``), run by hand on every rank:
params and optimizer state are stored as each rank's blocks under
``tree_shardings``; the forward and backward run on the rank's rows of the
global batch (the batch splits over every mesh axis), each weight gathered
from its blocks (in its own dtype) where it is used, a stacked leaf layer
by layer (``sharding.gather_weight`` / ``unbind``), and the loss is the
rank's share of the global token mean (``chunked_cross_entropy``).  The
gather's backward sums the ranks' gradients into each rank's block; a
replicated leaf's gradient is summed after the backward.  The clip takes
the global norm of the full gradients (each block's sum of squares
weighted by its share of the leaf, summed over the mesh), and the
optimizer updates each rank's blocks: block by block where its arithmetic
is elementwise (adamw), on the gathered leaf, gradient and state where it
is not (adafactor's row and column statistics, adamw8bit's 256-element
blocks), keeping the rank's block.  So the step equals the unsharded one
up to the order of the sums over ranks.  At world size 1 every gather and
every block is the tensor itself, and the step is the unsharded one.  MoE
archs are not trained under the FSDP mapping (the JAX package's
``use_fsdp_mapping`` never puts them there).

Which mapping a mesh step runs is the one installed when it is made
(``sharding.mapping_of``), as JAX's ``make_train_step(arch, tc, mesh)``
traces under whatever ``set_mesh`` installed: ``set_mesh(mesh)`` (as
``launch/train.py --mesh-data`` does) selects the tensor-parallel (TP)
mapping; ``set_mesh(mesh, data_only=True)``, or no mapping at all, the FSDP
one.  Under the TP mapping the batch splits over the batch axes (``("pod",
"data")``; the ranks of a model group hold the same rows) and the model
code splits its layers over ``model`` by hand (``models/transformer.py``,
``models/moe.py``), MoE archs included.  The gathers' backward sums each
weight's gradient into this rank's block; a leaf that every model rank
holds whole and uses as it is (norms, the router, ``A_log`` / ``D`` /
``dt_bias``: the leaves whose rule replicates them) has the same gradient
on every model rank and is summed over the batch axes only.  The loss and
ce are the batch ranks' shares, summed over the batch axes.  The global
norm and the optimizer treat the stored blocks as under FSDP.

On the card ``Trainer.run`` runs its steps with deterministic kernels
(``torch.use_deterministic_algorithms``; e.g. the embedding's backward
scatter-add uses atomics otherwise), so a resumed run ends bit-equal to an
uninterrupted one there too, as the JAX test demands on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.elastic import reshard_state
from repro_torch.distributed.fault import StepMonitor
from repro_torch.models import transformer as model_lib
from repro_torch.optim import make_optimizer, tree
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.serve.graphs import StepGraphs, step_key


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation factor
    ckpt_every: int = 50  # 0: no checkpoints
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.leaves(grads)))


@torch.no_grad()
def _clip_by_global_norm(grads, max_norm: float, norm: Optional[torch.Tensor] = None):
    """Scales every gradient leaf in place by min(1, max_norm / norm), in
    f32 and back to its dtype -> (grads, norm); ``norm`` defaults to the
    leaves' global norm."""
    norm = _global_norm(grads) if norm is None else norm
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tree.leaves(grads):
        g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


def value_and_grad(params, batch, arch: ArchConfig):
    """``jax.value_and_grad`` of ``train_loss`` -> (loss, ce, grads as a
    list in the params' flattening order, in their dtypes)."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = model_lib.train_loss(params, batch, arch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), metrics["ce"].detach(), list(grads)


def _loss_and_grads(params, batch, arch: ArchConfig, microbatches: int):
    """(loss, ce, grads): one pass, or ``microbatches`` equal microbatches
    run in order, each one's grads (in the params' dtypes) cast to f32,
    divided by the count and summed, as the JAX scan does."""
    if microbatches > 1:
        n = microbatches
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in tree.leaves(params)]
        losses, ces = [], []
        for i in range(n):
            mb = {k: v.reshape(n, -1, *v.shape[1:])[i] for k, v in batch.items()}
            loss, ce, g = value_and_grad(params, mb, arch)
            for acc, gi in zip(grads, g):
                acc.add_(gi.float().div_(n))
            losses.append(loss)
            ces.append(ce)
        return torch.stack(losses).mean(), torch.stack(ces).mean(), grads
    return value_and_grad(params, batch, arch)


def make_train_step(arch: ArchConfig, tc: TrainConfig, mesh=None) -> tuple[Callable, Callable]:
    """-> (step_fn, opt_init); ``step_fn(params, opt_state, batch, step) ->
    (params, opt_state, metrics)`` updates ``params`` and ``opt_state`` in
    place and returns them.  ``step`` is a Python int or a 0-d int32 tensor
    (the captured step's: the lr is then computed on its device).

    Gradient accumulation: the global batch splits into ``tc.microbatches``
    equal microbatches run in order (``_loss_and_grads``).  With ``mesh``,
    the FSDP/ZeRO-3 step of the module note: ``params`` and ``opt_state``
    are this rank's blocks (``elastic.reshard_state``), ``batch`` its rows
    (``Trainer`` draws them), ``opt_init`` takes the full params."""
    opt = make_optimizer(arch.optimizer)
    lr_fn = cosine_schedule(tc.lr, tc.warmup, tc.total_steps)
    if mesh is not None:
        return _mesh_step(arch, tc, mesh, opt, lr_fn), opt.init

    def step_fn(params, opt_state, batch, step):
        loss, ce, grads = _loss_and_grads(params, batch, arch, tc.microbatches)
        grads, gnorm = _clip_by_global_norm(grads, tc.grad_clip)
        opt_state = opt.apply(tree.unflatten(params, grads), opt_state, params, lr_fn(step))
        return params, opt_state, {"loss": loss, "ce": ce, "grad_norm": gnorm}

    return step_fn, opt.init


def capturable_step(step_fn: Callable, params, opt_state, names: tuple) -> Callable:
    """The function ``Trainer`` captures (and runs eagerly on the CPU and
    under ``graphs.disable_capture()``): ``fn(*batch, step) -> (loss, ce,
    grad_norm)``, the batch's tensors in ``names`` order and ``step`` a 0-d
    int32 tensor, over ``params`` and ``opt_state``, which it updates in
    place."""

    def fn(*inputs):
        *tensors, step = inputs
        _, _, metrics = step_fn(params, opt_state, dict(zip(names, tensors)), step)
        return metrics["loss"], metrics["ce"], metrics["grad_norm"]

    return fn


def _sharding(t) -> Optional[sh.NamedSharding]:
    """The sharding a block was cut with (``sharding.shard_local``); None
    for a full tensor."""
    return getattr(t, "_mesh_sharding", None)


def _full(t: torch.Tensor) -> torch.Tensor:
    s = _sharding(t)
    return t if s is None else sh.gather(t, s)


def _block(full: torch.Tensor, s: Optional[sh.NamedSharding]) -> torch.Tensor:
    return full if s is None else full[s.index(tuple(full.shape))]


def _same_layout(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return a.mesh is b.mesh and tuple(a.spec) == tuple(b.spec)


def _check_mesh_arch(arch: ArchConfig, mapping: str) -> None:
    if arch.n_experts and mapping == "fsdp":
        raise NotImplementedError(
            f"{arch.name} is an MoE arch: it trains on a mesh under the tensor-parallel "
            "mapping (sharding.set_mesh(mesh), as launch/train.py --mesh-data installs "
            "it), not under the FSDP mapping, from which the JAX package's "
            "use_fsdp_mapping excludes MoE archs")


def _replicated_leaves(params) -> list[bool]:
    """Per leaf (in flattening order), whether its rule replicates it: the
    leaves the model code uses as they are, never through a gather."""
    paths = tree.leaves(sh._map_with_path(lambda path, leaf: path, params))
    return [all(a is None for a in sh.param_spec(path, leaf.ndim))
            for path, leaf in zip(paths, tree.leaves(params))]


@torch.no_grad()
def _mesh_global_norm(grads: list, params, mesh) -> torch.Tensor:
    """The global norm of the full gradients from this rank's blocks of
    them: each block's f32 sum of squares times its leaf's shard factor
    over the mesh size (a block held by several ranks counts once), summed
    over the mesh."""
    n = sh.mesh_size(mesh)
    total = sum(torch.sum(torch.square(g.float())) *
                ((sh.shard_factor(_sharding(p)) if _sharding(p) else 1) / n)
                for g, p in zip(grads, tree.leaves(params)))
    return torch.sqrt(sh.mesh_all_reduce(total, mesh))


@torch.no_grad()
def _apply_blocks(opt, grads: list, state, params, lr):
    """``Optimizer.apply`` on this rank's blocks: ``grads``, ``params`` and
    ``state`` are blocks, the last two written in place (see the module
    note)."""
    t = state.step + 1
    for st, g, p in zip(opt.per_param(state.inner, params), grads, tree.leaves(params)):
        layout = _sharding(p)
        olds = tree.leaves(st)
        if opt.elementwise and all(_same_layout(_sharding(x), layout) for x in olds):
            u, new = opt.leaf(st, g, p, lr, t)
            for old, x in zip(olds, tree.leaves(new)):
                if x is not old:
                    old.copy_(x)
        else:
            g_full = g if layout is None else sh.gather(g, layout)
            u, new = opt.leaf(tree.map(_full, st), g_full, _full(p), lr, t)
            for old, x in zip(olds, tree.leaves(new)):
                if x is not old:
                    old.copy_(_block(x, _sharding(old)))
            u = _block(u, layout)
        p.add_(u)
        del u, new
    state.step.copy_(t)
    return state


def _mesh_step(arch: ArchConfig, tc: TrainConfig, mesh, opt, lr_fn) -> Callable:
    mapping = sh.mapping_of(mesh)
    _check_mesh_arch(arch, mapping)
    if mapping == "tp":
        return _tp_step(arch, tc, mesh, opt, lr_fn)

    def step_fn(params, opt_state, batch, step):
        with sh.use_mesh(mesh, data_only=True):
            loss, ce, grads = _loss_and_grads(params, batch, arch, tc.microbatches)
        # a weight gathered where it was used had the ranks' shares of its
        # gradient summed by the gather's backward; sum the others' here
        for p, g in zip(tree.leaves(params), grads):
            if _sharding(p) is None or not sh.moves(_sharding(p)):
                sh.mesh_all_reduce(g, mesh)
        loss, ce = sh.mesh_all_reduce(loss.clone(), mesh), sh.mesh_all_reduce(ce.clone(), mesh)
        grads, gnorm = _clip_by_global_norm(grads, tc.grad_clip,
                                            _mesh_global_norm(grads, params, mesh))
        opt_state = _apply_blocks(opt, grads, opt_state, params, lr_fn(step))
        return params, opt_state, {"loss": loss, "ce": ce, "grad_norm": gnorm}

    return step_fn


def mesh_value_and_grad(params, batch, arch: ArchConfig, mesh, microbatches: int = 1):
    """The TP mapping's (loss, ce, grads) on ``mesh`` from this rank's
    blocks and rows: loss and ce summed over the batch ranks, each gradient
    this rank's block of the full gradient (see the module note)."""
    with sh.use_mesh(mesh):
        loss, ce, grads = _loss_and_grads(params, batch, arch, microbatches)
        for g, rep in zip(grads, _replicated_leaves(params)):
            if rep:
                sh.batch_all_reduce(g)
        loss, ce = sh.batch_all_reduce(loss.clone()), sh.batch_all_reduce(ce.clone())
    return loss, ce, grads


def _tp_step(arch: ArchConfig, tc: TrainConfig, mesh, opt, lr_fn) -> Callable:
    def step_fn(params, opt_state, batch, step):
        loss, ce, grads = mesh_value_and_grad(params, batch, arch, mesh, tc.microbatches)
        grads, gnorm = _clip_by_global_norm(grads, tc.grad_clip,
                                            _mesh_global_norm(grads, params, mesh))
        opt_state = _apply_blocks(opt, grads, opt_state, params, lr_fn(step))
        return params, opt_state, {"loss": loss, "ce": ce, "grad_norm": gnorm}

    return step_fn


def mesh_rows(mesh, global_batch: int, microbatches: int = 1,
              axes: Optional[tuple[str, ...]] = None) -> list[tuple[int, int]]:
    """The rows of the global batch this rank of ``mesh`` holds, the batch
    dim sharded over ``axes`` major to minor (default every axis: the FSDP
    mapping; the TP mapping's are the batch axes, ``("pod", "data")``): one
    slice of each microbatch, so that the step's reshape into microbatches
    gives each rank its rows of every global microbatch."""
    sizes = sh.mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    axes = tuple(sizes) if axes is None else tuple(a for a in axes if a in sizes)
    n_dev = 1
    r = 0
    for a in axes:
        n_dev *= sizes[a]
        r = r * sizes[a] + coord[a]
    if global_batch % (n_dev * microbatches):
        raise ValueError(f"global batch {global_batch} does not split over {n_dev} devices "
                         f"x {microbatches} microbatches")
    per_mb = global_batch // microbatches
    rows = per_mb // n_dev
    return [(i * per_mb + r * rows, i * per_mb + (r + 1) * rows) for i in range(microbatches)]


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic kernels on the card for the block (cuBLAS with a fixed
    workspace, as ``torch.use_deterministic_algorithms`` requires), without
    the mode's fill of every new tensor (a debugging aid that adds a kernel
    per allocation and changes no result); the settings are restored after
    it.  The CPU's kernels are deterministic already."""
    if device.type != "cuda":
        yield
        return
    from torch.utils import deterministic as det

    was_on, was_fill = torch.are_deterministic_algorithms_enabled(), det.fill_uninitialized_memory
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = env or ":4096:8"
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was_on)
        det.fill_uninitialized_memory = was_fill
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


@dataclass
class Trainer:
    arch: ArchConfig
    tc: TrainConfig
    data: DataConfig
    seed: int = 0
    monitor: StepMonitor = field(default_factory=StepMonitor)
    device: Any = None  # the card unless named
    mesh: Any = None  # a DeviceMesh: the step over it under the installed mapping

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ckpt = CheckpointManager(self.tc.ckpt_dir, keep=self.tc.ckpt_keep)
        self.step_fn, self.opt_init = make_train_step(self.arch, self.tc, self.mesh)
        self.history: list[dict] = []
        self.graphs = StepGraphs(self.device)  # the captured step (no mesh)
        self._state = None  # (params, opt_state) the step updates in place
        self._inputs = None  # the step's static input buffers (batch..., step)
        self._names = ()  # the batch keys, in the buffers' order
        self._row_axes = None  # the mapping's batch axes (sharding.batch_axes)
        if self.mesh is not None:
            fsdp = sh.mapping_of(self.mesh) == "fsdp"
            with sh.use_mesh(self.mesh, data_only=fsdp):
                self._row_axes = sh.batch_axes()
            mesh_rows(self.mesh, self.data.global_batch, self.tc.microbatches,
                      self._row_axes)  # divisible

    def init_state(self):
        """Params and optimizer state: full, or on a mesh this rank's blocks
        of them (drawn full, then cut: at world size 1 the blocks are the
        full tensors)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = model_lib.init_params(self.arch, gen)
        opt_state = self.opt_init(params)
        if self.mesh is None:
            return params, opt_state
        return reshard_state(params, self.mesh), reshard_state(opt_state, self.mesh)

    def batch(self, step: int) -> dict:
        """The step's batch: all of it, or on a mesh this rank's rows of it
        (``mesh_rows``, over the mapping's batch axes), the prefix
        embeddings of a vlm / audio arch drawn for the global batch and
        sliced (``make_batch`` draws them per slice)."""
        if self.mesh is None:
            return make_batch(self.data, step, self.arch, device=self.device)
        rows = mesh_rows(self.mesh, self.data.global_batch, self.tc.microbatches,
                         self._row_axes)
        parts = [make_batch(self.data, step, None, host_slice=r, device=self.device)
                 for r in rows]
        batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        if self.arch.prefix_len:
            from repro_torch.models.frontends import prefix_embeddings

            pre = prefix_embeddings(self.arch, self.data.global_batch,
                                    seed=self.data.seed + step, device=self.device)
            batch["prefix_emb"] = torch.cat([pre[lo:hi] for lo, hi in rows])
        return batch

    def load(self, step: int) -> tuple:
        """The step's inputs in the static buffers (made at the first call):
        :meth:`batch` copied in, then the step."""
        batch = self.batch(step)
        if self._inputs is None:
            self._names = tuple(sorted(batch))
            self._inputs = tuple(torch.empty_like(batch[k]) for k in self._names) + (
                torch.zeros((), dtype=torch.int32, device=self.device),)
        for dst, k in zip(self._inputs, self._names):
            dst.copy_(batch[k])
        self._inputs[-1].fill_(step)
        return self._inputs

    def step(self, params, opt_state, inputs: tuple) -> dict:
        """One step on :meth:`load`'s buffers, captured on the card (see the
        module note) -> its metrics (the graph's outputs on a replay: read
        them before the next step)."""
        fn = capturable_step(self.step_fn, params, opt_state, self._names)
        loss, ce, gnorm = self.graphs.run(step_key("train", None, (), inputs), fn, inputs,
                                          static=True)
        return {"loss": loss, "ce": ce, "grad_norm": gnorm}

    def _start_state(self, latest: Optional[int]):
        """The run's starting params and state: restored from checkpoint
        ``latest``, or drawn.  Without a mesh, a Trainer's later runs write
        them into its first run's tensors, over which the step was captured
        (a restore goes from the host leaf by leaf: no second copy on the
        device)."""
        if self.mesh is not None or self._state is None:
            state = self._restore(latest) if latest is not None else self.init_state()
            if self.mesh is None:
                self._state = state
            return state
        live = tree.leaves(self._state)
        if latest is not None:
            leaves, _ = self.ckpt.restore(latest)
        else:
            leaves = tree.leaves(self.init_state())
        if len(leaves) != len(live):
            raise ValueError(f"the start state has {len(leaves)} leaves, the step's {len(live)}")
        for dst, src in zip(live, leaves):
            dst.copy_(src)
        del leaves
        return self._state

    def _is_writer(self) -> bool:
        """Whether this process writes the checkpoints: rank 0 of a mesh."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _sync(self) -> None:
        if self.mesh is not None:
            torch.distributed.barrier()

    def _save(self, step: int, params, opt_state) -> None:
        """A host-gathered checkpoint: on a mesh every rank gathers, rank 0
        writes."""
        state = (params, opt_state)
        if self.mesh is not None:
            state = tree.map(lambda t: _full(t) if torch.is_tensor(t) else t, state)
        if self._is_writer():
            self.ckpt.save(step, state, blocking=False)

    def run(
        self,
        num_steps: int,
        start_step: int = 0,
        fail_at: Optional[int] = None,  # fault-injection hook (tests)
    ) -> dict:
        """Steps ``start_step`` .. ``num_steps - 1``; ``start_step == -1``
        (``run_with_restarts``' resume sentinel), or 0 with a checkpoint on
        disk, resumes from the latest checkpoint.  A checkpoint is written
        every ``tc.ckpt_every`` steps and after the last.  Without a mesh
        the returned params and state are the Trainer's own tensors, which
        its next run overwrites (see the module note)."""
        self.ckpt.wait()  # a save a failed attempt left running lands first
        self._sync()
        latest = None
        if start_step == -1 or (start_step == 0 and self.ckpt.latest_step() is not None):
            latest = self.ckpt.latest_step()
            start_step = latest if latest is not None else 0
        params, opt_state = self._start_state(latest)

        with deterministic(self.device):
            for step in range(start_step, num_steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                if self.mesh is None:
                    inputs = self.load(step)
                    t0 = time.perf_counter()
                    metrics = self.step(params, opt_state, inputs)
                else:
                    batch = self.batch(step)
                    t0 = time.perf_counter()
                    params, opt_state, metrics = self.step_fn(params, opt_state, batch, step)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                straggler = self.monitor.observe(step, dt)
                self.history.append({
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "sec": dt,
                    "straggler": straggler,
                })
                if self.tc.ckpt_every and ((step + 1) % self.tc.ckpt_every == 0
                                           or step + 1 == num_steps):
                    self._save(step + 1, params, opt_state)
        self.ckpt.wait()
        self._sync()
        return {"params": params, "opt_state": opt_state, "history": self.history}

    def _restore(self, step: int):
        proto = self.init_state()
        shardings = None
        if self.mesh is not None:
            shardings = tree.map(
                lambda t: _sharding(t) or sh.NamedSharding(self.mesh, sh.P()), proto)
        state, _ = self.ckpt.restore(step, target=proto, shardings=shardings)
        return state
