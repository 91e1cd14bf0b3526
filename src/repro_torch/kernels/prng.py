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
  mantissa of a float in [1, 2), minus 1;
- ``normal(key, shape)``: ``jax.random.normal(key, shape, float32)``: the
  bits of element ``i`` (row-major) are ``b0 ^ b1`` of ``threefry2x32(key,
  (i >> 32, i & 0xFFFFFFFF))``, made uniform as above on ``[nextafter(-1,
  0), 1)``, then ``sqrt(2) * erfinv(u)`` with XLA's float32 ``erf_inv``
  (Giles' polynomials), whose steps are rounded once each as XLA's fused
  multiply-adds round them.  The uniforms are bit-equal to JAX's; the
  normals lie within an ulp or two of JAX's (``log1p`` may round
  otherwise).
"""
from __future__ import annotations

import math
import numbers

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "uniform", "normal_uniforms", "normal"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = float(np.float32(math.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


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
    return _to_unit(b0 ^ b1)


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): the top 23 as the mantissa of a
    float in [1, 2), minus 1."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)


# XLA's ErfInv32: degree-9 polynomials in w = -log1p(-x^2) - 2.5 (w < 5) or
# sqrt(w) - 3, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` as XLA computes it; each Horner step is evaluated
    in float64 and rounded once, as a fused multiply-add."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.full_like(w, 0.0)
    for lo5, hi5 in zip(_ERFINV_LT5, _ERFINV_GE5):
        coef = torch.where(lt, torch.tensor(lo5, dtype=torch.float32, device=x.device),
                           torch.tensor(hi5, dtype=torch.float32, device=x.device))
        p = (coef.double() + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, out)


def normal_uniforms(key: torch.Tensor, shape) -> torch.Tensor:
    """The uniforms :func:`normal` starts from: ``jax.random.uniform(key,
    shape, jnp.float32, nextafter(-1, 0), 1)``, flat, on the key's device."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _MASK)
    # (maxval - minval) rounds to 2.0 in float32, so the scaling is exact
    return torch.clamp_min(_to_unit(b0 ^ b1) * 2.0 + _NORMAL_LO, _NORMAL_LO)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)`` for one key ``[2]``,
    drawn on the key's device (see the module note)."""
    return (_erfinv(normal_uniforms(key, shape)) * _SQRT2).reshape(shape)
