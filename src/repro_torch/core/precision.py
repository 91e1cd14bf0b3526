"""Precision definitions for SPEED's multi-precision datapath.

The paper (Sec. II-C) packs adjacent operands along the input-channel
dimension into a fixed-width "unified element": one 16-bit, four 8-bit or
sixteen 4-bit operands.  A PE holds sixteen 4-bit multipliers, combined into
1 x 16-bit, 4 x 8-bit or 16 x 4-bit MACs per cycle (Sec. II-B).  This is the
part of ``repro/core/precision.py`` the serving path uses: the signed ranges
``pack_weights`` and ``quantize_kv`` clip to.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

__all__ = ["Precision", "PrecisionSpec", "PRECISION_SPECS"]


class Precision(enum.IntEnum):
    """Operand precisions supported by SPEED's datapath (paper: 4~16 bit)."""

    INT4 = 4
    INT8 = 8
    INT16 = 16

    @property
    def spec(self) -> "PrecisionSpec":
        return PRECISION_SPECS[self]

    @classmethod
    def from_bits(cls, bits: int) -> "Precision":
        try:
            return cls(bits)
        except ValueError:
            raise ValueError(
                f"SPEED supports 4/8/16-bit operands, got {bits}-bit"
            ) from None


@dataclass(frozen=True)
class PrecisionSpec:
    """Static geometry of one precision mode.

    bits: operand width; ops_per_element: operands per unified element;
    macs_per_pe: MACs one PE performs per cycle in this mode; digits: 4-bit
    digits per operand; qmin/qmax: the signed integer range.
    """

    bits: int
    ops_per_element: int
    macs_per_pe: int
    digits: int

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


PRECISION_SPECS: dict[Precision, PrecisionSpec] = {
    Precision.INT16: PrecisionSpec(bits=16, ops_per_element=1, macs_per_pe=1, digits=4),
    Precision.INT8: PrecisionSpec(bits=8, ops_per_element=4, macs_per_pe=4, digits=2),
    Precision.INT4: PrecisionSpec(bits=4, ops_per_element=16, macs_per_pe=16, digits=1),
}
