"""LR schedules (pure functions of the step), in float32 as the JAX
package computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; returns a 0-d float32 CPU tensor (a scalar to
    any device's ops)."""

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32).cpu()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        # the float32 cosine correctly rounded, as XLA's is (PyTorch's float32
        # cos can land an ulp off, which 1 + cos amplifies near the end)
        cos = base_lr * 0.5 * (1.0 + torch.cos((math.pi * prog).double()).float())
        return torch.where(step < warmup, warm, cos)

    return lr
