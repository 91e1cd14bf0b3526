"""LR schedules (pure functions of the step), in float32 as the JAX
package computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; returns a 0-d float32 tensor on the step's
    device (a Python step gives a CPU tensor, a scalar to any device's ops).

    A step tensor on the card gives the lr computed there, so a captured
    train step (``train/trainer.py``) reads each replay's step from its
    input buffer instead of baking one lr into the graph.  Every operation
    rounds as XLA's does on either device: the divisors are tensors (CUDA
    divides by a Python scalar as a multiply by its reciprocal, an ulp off)
    and the cosine is the float64 one rounded once to float32."""

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)

        def const(x) -> torch.Tensor:
            return torch.full((), float(x), dtype=torch.float32, device=step.device)

        warm = base_lr * step / const(max(warmup, 1))
        prog = torch.clamp((step - warmup) / const(max(total - warmup, 1)), 0.0, 1.0)
        # the float32 cosine correctly rounded, as XLA's is (PyTorch's float32
        # cos can land an ulp off, which 1 + cos amplifies near the end)
        cos = base_lr * 0.5 * (1.0 + torch.cos((math.pi * prog).double()).float())
        return torch.where(step < warmup, warm, cos)

    return lr
