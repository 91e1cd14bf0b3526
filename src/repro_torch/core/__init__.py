"""SPEED's core, ported from ``repro.core``: precision modes (``precision``),
the custom instructions (``isa``), the systolic-array numerical model
(``sau``), FF/CF dataflow mapping (``dataflow``), the conv -> program
assembler and its functional simulator (``assembler``, ``interpreter``) and
the cycle model that picks a dataflow per layer (``perfmodel``)."""
from repro_torch.core.dataflow import ConvLayer, HardwareGeometry
from repro_torch.core.isa import VSACFG, VSALD, VSAM, Dataflow, decode, encode
from repro_torch.core.precision import Precision
from repro_torch.core.sau import SAU

__all__ = [
    "ConvLayer",
    "HardwareGeometry",
    "VSACFG",
    "VSALD",
    "VSAM",
    "Dataflow",
    "decode",
    "encode",
    "Precision",
    "SAU",
]
