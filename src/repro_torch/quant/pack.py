"""Bit-packing for sub-byte operands.

Two signed int4 operands ride in one int8 byte, so one byte of memory
traffic carries two multiply operands: the memory-side half of the paper's
"combine the multipliers" trick.  The CUDA kernels unpack in-register with
the same bit operations used here.  Port of ``repro/quant/pack.py``.
"""
from __future__ import annotations

import torch

__all__ = ["pack_int4", "unpack_int4"]


def pack_int4(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Packs signed int4 values (int8 storage, range [-8, 7]) pairwise along
    ``dim`` into int8 bytes: even index -> low nibble, odd -> high nibble.
    The packed dim halves in length."""
    x = x.to(torch.int8)
    dim = dim % x.ndim
    if x.shape[dim] % 2 != 0:
        raise ValueError(f"dim {dim} length {x.shape[dim]} must be even to pack")
    pairs = x.unfold(dim, 2, 2)  # [..., n/2, ..., 2]: (even, odd) along the end
    lo, hi = pairs[..., 0], pairs[..., 1]
    return ((hi << 4) | (lo & 0x0F)).to(torch.int8).contiguous()


def unpack_int4(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: an int8 tensor of doubled length with
    sign-extended 4-bit values (arithmetic shifts keep the sign)."""
    packed = packed.to(torch.int8)
    dim = dim % packed.ndim
    lo = (packed << 4) >> 4
    hi = packed >> 4
    stacked = torch.stack([lo, hi], dim=dim + 1)  # [..., n, 2, ...]
    shape = list(packed.shape)
    shape[dim] *= 2
    return stacked.reshape(shape)
