"""Symmetric linear quantization (port of ``repro/quant/quantize.py``).

The paper deploys multi-precision quantized DNNs (4/8/16-bit signed ints
with per-tensor or per-channel scales); this is the numerical substrate:
absmax scales, quantize / dequantize, fake-quantize, and the ``QTensor``
container (int4 payloads bit-packed along the last axis, ``quant/pack.py``).
Plain torch ops on whichever device the input lies on; on float32 inputs the
payloads and scales are the JAX module's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.precision import Precision
from repro_torch.quant.pack import pack_int4, unpack_int4

__all__ = [
    "QTensor",
    "absmax_scale",
    "quantize",
    "quantize_per_channel",
    "dequantize",
    "fake_quantize",
]

_STORE_DTYPE = {Precision.INT4: torch.int8, Precision.INT8: torch.int8,
                Precision.INT16: torch.int16}
_TINY = torch.finfo(torch.float32).tiny


@dataclass
class QTensor:
    """A quantized tensor: integer payload + scale (+ packing metadata).

    ``data`` holds int8 / int16 storage; for INT4 with ``packed`` the last
    axis is bit-packed two to a byte (length halved).  ``scale`` broadcasts
    against the logical (unpacked) shape."""

    data: torch.Tensor
    scale: torch.Tensor
    precision: Precision
    packed: bool = False

    @property
    def logical_shape(self) -> tuple[int, ...]:
        s = list(self.data.shape)
        if self.packed:
            s[-1] *= 2
        return tuple(s)

    def unpacked(self) -> torch.Tensor:
        """Integer payload with INT4 unpacked to one value per int8."""
        return unpack_int4(self.data, dim=-1) if self.packed else self.data

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.unpacked().to(dtype) * self.scale.to(dtype)).to(dtype)

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() + self.scale.numel() * 4


def _axes(x: torch.Tensor, channel_axis: int) -> tuple[int, ...]:
    return tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)


def _absmax(x: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    dims = tuple(range(x.ndim)) if axis is None else axis
    return torch.clamp_min(x.abs().amax(dim=dims, keepdim=keepdims).float(), _TINY)


def absmax_scale(x: torch.Tensor, precision: Precision, axis=None,
                 keepdims: bool = True) -> torch.Tensor:
    """Symmetric absmax scale (float32) so that max|x| maps to qmax."""
    return _absmax(x, axis, keepdims) / precision.spec.qmax


def _round_clip(x: torch.Tensor, precision: Precision) -> torch.Tensor:
    spec = precision.spec
    return torch.clamp(torch.round(x), spec.qmin, spec.qmax)


def quantize(x: torch.Tensor, precision: Precision, scale: Optional[torch.Tensor] = None,
             pack: bool = True) -> QTensor:
    """Per-tensor symmetric quantization (or with the given ``scale``).  INT4
    payloads are bit-packed along the last axis when ``pack`` and its length
    is even."""
    if scale is None:
        scale = absmax_scale(x, precision)
    q = _round_clip(x / scale, precision).to(_STORE_DTYPE[precision])
    packed = precision is Precision.INT4 and pack and q.shape[-1] % 2 == 0
    if packed:
        q = pack_int4(q, dim=-1)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return QTensor(data=q, scale=scale, precision=precision, packed=packed)


def quantize_per_channel(x: torch.Tensor, precision: Precision, channel_axis: int = -1,
                         pack: bool = True) -> QTensor:
    """Per-channel (typically output-feature) symmetric quantization."""
    scale = absmax_scale(x, precision, axis=_axes(x, channel_axis), keepdims=True)
    return quantize(x, precision, scale=scale, pack=pack)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    return q.dequantize(dtype)


def fake_quantize(x: torch.Tensor, precision: Precision,
                  channel_axis: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize in one step: the value a deployed precision
    leaves of ``x``.  The scale is absmax times the float32 reciprocal of
    qmax, as the jitted JAX function computes it (XLA folds the division by
    the constant into that product), so the values are JAX's bit for bit."""
    axis = None if channel_axis is None else _axes(x, channel_axis)
    recip = torch.tensor(1.0 / precision.spec.qmax, dtype=torch.float32)
    scale = _absmax(x, axis, keepdims=True) * recip.to(x.device)
    return (_round_clip(x / scale, precision) * scale).to(x.dtype)
