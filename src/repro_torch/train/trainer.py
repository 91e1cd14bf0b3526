"""Training loop (port of ``repro/train/trainer.py``): a train step with
gradient accumulation, global-norm clipping and the LR schedule; async
checkpointing, straggler monitoring and crash-resume.

The step runs eagerly (the JAX package jits it with donated params and
state; a captured train step is not ported yet).  Where JAX maps a function
over the whole tree, the step works leaf by leaf and in place, with the
same arithmetic: the clip scales each gradient in place, and
``Optimizer.apply`` writes the new params and state into the old tensors.
So at llama3.2-3b's width no tree-wide f32 copy of the gradients (14.4 GB)
or update tree (7.2 GB) joins the 43.3 GB of bf16 params and grads and f32
m and v.

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
from repro_torch.distributed.fault import StepMonitor
from repro_torch.models import transformer as model_lib
from repro_torch.optim import make_optimizer, tree
from repro_torch.optim.schedules import cosine_schedule


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation factor
    ckpt_every: int = 50
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.leaves(grads)))


@torch.no_grad()
def _clip_by_global_norm(grads, max_norm: float):
    """Scales every gradient leaf in place by min(1, max_norm / norm), in
    f32 and back to its dtype -> (grads, norm)."""
    norm = _global_norm(grads)
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


def make_train_step(arch: ArchConfig, tc: TrainConfig) -> tuple[Callable, Callable]:
    """-> (step_fn, opt_init); ``step_fn(params, opt_state, batch, step) ->
    (params, opt_state, metrics)`` updates ``params`` and ``opt_state`` in
    place and returns them.

    Gradient accumulation: the global batch splits into ``tc.microbatches``
    equal microbatches run in order; each one's grads (in the params'
    dtypes) are cast to f32, divided by the count and summed, as the JAX
    scan does."""
    opt = make_optimizer(arch.optimizer)
    lr_fn = cosine_schedule(tc.lr, tc.warmup, tc.total_steps)

    def step_fn(params, opt_state, batch, step):
        if tc.microbatches > 1:
            n = tc.microbatches
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in tree.leaves(params)]
            losses, ces = [], []
            for i in range(n):
                mb = {k: v.reshape(n, -1, *v.shape[1:])[i] for k, v in batch.items()}
                loss, ce, g = value_and_grad(params, mb, arch)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float().div_(n))
                losses.append(loss)
                ces.append(ce)
            loss, ce = torch.stack(losses).mean(), torch.stack(ces).mean()
        else:
            loss, ce, grads = value_and_grad(params, batch, arch)
        grads, gnorm = _clip_by_global_norm(grads, tc.grad_clip)
        opt_state = opt.apply(tree.unflatten(params, grads), opt_state, params, lr_fn(step))
        return params, opt_state, {"loss": loss, "ce": ce, "grad_norm": gnorm}

    return step_fn, opt.init


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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ckpt = CheckpointManager(self.tc.ckpt_dir, keep=self.tc.ckpt_keep)
        self.step_fn, self.opt_init = make_train_step(self.arch, self.tc)
        self.history: list[dict] = []

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = model_lib.init_params(self.arch, gen)
        return params, self.opt_init(params)

    def run(
        self,
        num_steps: int,
        start_step: int = 0,
        fail_at: Optional[int] = None,  # fault-injection hook (tests)
    ) -> dict:
        """Steps ``start_step`` .. ``num_steps - 1``; ``start_step == -1``
        (``run_with_restarts``' resume sentinel), or 0 with a checkpoint on
        disk, resumes from the latest checkpoint.  A checkpoint is written
        every ``tc.ckpt_every`` steps and after the last."""
        self.ckpt.wait()  # a save a failed attempt left running lands first
        if start_step == -1 or (start_step == 0 and self.ckpt.latest_step() is not None):
            latest = self.ckpt.latest_step()
            if latest is not None:
                params, opt_state = self._restore(latest)
                start_step = latest
            else:
                params, opt_state = self.init_state()
                start_step = 0
        else:
            params, opt_state = self.init_state()

        with deterministic(self.device):
            for step in range(start_step, num_steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = make_batch(self.data, step, self.arch, device=self.device)
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
                if (step + 1) % self.tc.ckpt_every == 0 or step + 1 == num_steps:
                    self.ckpt.save(step + 1, (params, opt_state), blocking=False)
        self.ckpt.wait()
        return {"params": params, "opt_state": opt_state, "history": self.history}

    def _restore(self, step: int):
        state, _ = self.ckpt.restore(step, target=self.init_state())
        return state
