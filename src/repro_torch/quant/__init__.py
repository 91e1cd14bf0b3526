"""Quantization substrate of the port (``repro.quant``): packing
(``pack``), scales, quantize / dequantize and the ``QTensor`` container
(``quantize``)."""
from repro_torch.quant.pack import pack_int4, pack_int4_hi_lo, unpack_int4
from repro_torch.quant.quantize import (
    QTensor,
    absmax_scale,
    dequantize,
    fake_quantize,
    quantize,
    quantize_per_channel,
)

__all__ = [
    "QTensor",
    "absmax_scale",
    "dequantize",
    "fake_quantize",
    "quantize",
    "quantize_per_channel",
    "pack_int4",
    "unpack_int4",
    "pack_int4_hi_lo",
]
