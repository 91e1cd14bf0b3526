"""The port's threefry2x32, bit-equal to ``jax.random``'s (JAX's default
threefry implementation with ``jax_threefry_partitionable=True``).

PyTorch has no counterpart of ``jax.random``, and the serving engine's
sampled streams must equal the JAX engine's under a fixed seed, so the
keys and uniforms are recomputed here from the same hash.  A key is a
``[..., 2]`` int64 tensor whose entries lie in ``[0, 2**32)``: torch has no
unsigned 32-bit arithmetic, so every sum is masked back to 32 bits.  The
functions are plain torch ops and run on whichever device their inputs lie
on.

- ``threefry2x32(key, x)``: 20 rounds in 5 groups of 4, rotations
  ``[13, 15, 26, 6]`` and ``[17, 29, 16, 24]`` alternating, key schedule
  ``[k0, k1, k0 ^ k1 ^ 0x1BD11BDA]`` injected after every group;
- ``prng_key(seed)`` = ``(0, seed)`` (``jax.random.PRNGKey`` of a 32-bit
  seed);
- ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))``;
- ``uniform(key)``: ``jax.random.uniform(key, ())``: the bits
  ``b0 ^ b1`` of ``threefry2x32(key, (0, 0))``, their top 23 as the
  mantissa of a float in [1, 2), minus 1.
"""
from __future__ import annotations

import numbers

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x, device=None) -> torch.Tensor:
    """An integer tensor, or a Python int, as int64 holding its low 32 bits.
    An int becomes a 0-d tensor filled on ``device``, never a copy from the
    host, so a captured step (``serve/graphs.py``) holds no host pointer."""
    if isinstance(x, numbers.Integral):
        return torch.full((), int(x) & _MASK, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def threefry2x32(key: torch.Tensor, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key [..., 2]``;
    returns the two output words, int64 in ``[0, 2**32)``."""
    k0, k1 = _u32(key[..., 0]), _u32(key[..., 1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_u32(x0, k0.device) + ks[0]) & _MASK
    x1 = (_u32(x1, k0.device) + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: ``[..., 2]`` = (0, seed)."""
    s = _u32(seed)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the 32-bit ``data``."""
    d = _u32(data, key.device)
    return torch.stack(threefry2x32(key, torch.zeros_like(d), d), dim=-1)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, ())`` per key: float32 in [0, 1)."""
    zero = torch.zeros(key.shape[:-1], dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, zero, zero)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
