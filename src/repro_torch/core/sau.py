"""Functional model of SPEED's multi-precision Systolic Array Unit (SAU)
(port of ``repro/core/sau.py``).

Paper Sec. II-B: each lane holds a ``TILE_R x TILE_C`` array of PEs; each PE
holds sixteen 4-bit multipliers that combine into 1 x 16-bit, 4 x 8-bit or
16 x 4-bit MACs per cycle.  This is the bit-accurate numerical model of that
fabric as torch integer ops, on whichever device the inputs lie on:

  * :func:`digit_decompose` / :func:`digit_compose`: the radix-16 (4-bit
    digit) split and combine the hardware uses to build wide multiplies out
    of 4-bit multipliers;
  * :func:`pe_multiply`: one PE's product built only from 4-bit x 4-bit
    partial products (what the sixteen multipliers compute);
  * :class:`SAU`: the tile, a multi-precision matmul-accumulate over unified
    elements, the execute stage of VSAM in ``core/interpreter.py``.

Results are int32 and wrap modulo 2**32 as the hardware's 32-bit
accumulators (and JAX's int32 arithmetic) do: every sum is formed exactly in
int64 and wrapped once, which gives the same bits as summing in int32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.precision import PE_MULTIPLIERS_4B, Precision

__all__ = ["digit_decompose", "digit_compose", "pe_multiply", "pe_mac", "SAU"]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _int64(x) -> torch.Tensor:
    """Integers as int64 holding their int32 value, as ``jnp.asarray(x,
    jnp.int32)`` reads them."""
    return _wrap32(torch.as_tensor(x).to(torch.int64)).to(torch.int64)


def digit_decompose(x, bits: int) -> torch.Tensor:
    """Splits signed ``bits``-wide integers into radix-16 digits,
    little-endian: an int32 tensor with a trailing axis of ``bits // 4``
    digits.  Every digit is an unsigned low nibble except the top one, which
    keeps the sign (a two's-complement array multiplier's convention), so
    ``sum_i digits[..., i] * 16**i == x``."""
    rem = _int64(x)
    digits = []
    for _ in range(bits // 4 - 1):
        d = rem & 0xF  # unsigned low nibble
        digits.append(d)
        rem = (rem - d) >> 4  # exact arithmetic shift once the nibble is gone
    digits.append(rem)  # signed top digit
    return torch.stack(digits, dim=-1).to(torch.int32)


def digit_compose(digits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`digit_decompose` (last axis = digits)."""
    n = digits.shape[-1]
    weights = 16 ** torch.arange(n, dtype=torch.int64, device=digits.device)
    return _wrap32((digits.to(torch.int64) * weights).sum(dim=-1))


def pe_multiply(a, b, precision: Precision) -> torch.Tensor:
    """Product of two signed ``precision``-bit operands the way a SPEED PE
    forms it: the sum of shifted 4-bit x 4-bit partial products.  With
    ``a = sum_i a_i 16^i`` and ``b = sum_j b_j 16^j``, ``a*b = sum_{i,j}
    a_i b_j 16^{i+j}``: digits**2 of the sixteen multipliers (16 at 16-bit,
    1 MAC a PE; 4 at 8-bit; 1 at 4-bit).  ``a`` and ``b`` broadcast."""
    spec = precision.spec
    da = digit_decompose(a, spec.bits).to(torch.int64)[..., :, None]  # [..., i, 1]
    db = digit_decompose(b, spec.bits).to(torch.int64)[..., None, :]  # [..., 1, j]
    n = spec.digits
    assert n * n * spec.macs_per_pe == PE_MULTIPLIERS_4B
    idx = torch.arange(n, dtype=torch.int64, device=da.device)
    shift = 16 ** (idx[:, None] + idx[None, :])
    return _wrap32((da * db * shift).sum(dim=(-2, -1)))


def pe_mac(acc, a, b, precision: Precision) -> torch.Tensor:
    """Multiply-accumulate into a 32-bit accumulator (the hardware's acc
    register)."""
    prod = pe_multiply(a, b, precision)
    return _wrap32(_int64(acc).to(prod.device) + prod.to(torch.int64))


@dataclass(frozen=True)
class SAU:
    """One lane's systolic array: TILE_R x TILE_C PEs.

    ``__call__`` is the matmul-accumulate a burst of VSAM instructions maps
    onto the tile: inputs ``[R, K]`` (R feature-map rows, K reduced
    operands), weights ``[K, C]`` (C output channels across PE columns), acc
    ``[R, C]`` int32.  The cycle model lives in ``core/perfmodel.py``."""

    tile_r: int = 4
    tile_c: int = 4

    def __call__(self, acc, inputs, weights, precision: Precision, *,
                 bit_accurate: bool = False) -> torch.Tensor:
        inputs, weights = torch.as_tensor(inputs), torch.as_tensor(weights)
        if inputs.ndim != 2 or weights.ndim != 2:
            raise ValueError("SAU operates on [R,K] x [K,C]")
        r, k = inputs.shape
        k2, c = weights.shape
        if k != k2:
            raise ValueError(f"reduction mismatch {k} vs {k2}")
        if r > self.tile_r or c > self.tile_c:
            raise ValueError(
                f"operands [{r},{k}]x[{k},{c}] exceed tile {self.tile_r}x{self.tile_c}"
            )
        if bit_accurate:
            # every product from 4-bit partial products (the slow oracle)
            prod = pe_multiply(inputs[:, :, None], weights[None, :, :], precision)
            out = prod.to(torch.int64).sum(dim=1)
        else:
            out = (_int64(inputs)[:, :, None] * _int64(weights)[None, :, :]).sum(dim=1)
        return _wrap32(_int64(acc).to(out.device) + out)

    def cycles(self, r: int, c: int, k_elements: int, precision: Precision) -> int:
        """Cycles to reduce ``k_elements`` unified elements over an [r, c]
        facet (systolic fill / drain + one element per cycle)."""
        del precision  # element throughput is precision-independent by design
        r_tiles = math.ceil(r / self.tile_r)
        c_tiles = math.ceil(c / self.tile_c)
        fill_drain = self.tile_r + self.tile_c - 2
        return r_tiles * c_tiles * (k_elements + fill_drain)
