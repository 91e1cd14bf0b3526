"""Precision definitions for SPEED's multi-precision datapath.

The paper (Sec. II-C) packs adjacent operands along the input-channel
dimension into a fixed-width "unified element": one 16-bit, four 8-bit or
sixteen 4-bit operands.  A PE holds sixteen 4-bit multipliers, combined into
1 x 16-bit, 4 x 8-bit or 16 x 4-bit MACs per cycle (Sec. II-B).  This is
``repro/core/precision.py`` ported whole: the signed ranges ``pack_weights``
and ``quantize_kv`` clip to, and the PE geometry the cycle model
(``core/dataflow.py``, ``core/perfmodel.py``) reads.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

__all__ = [
    "Precision",
    "PrecisionSpec",
    "PRECISION_SPECS",
    "UNIFIED_ELEMENT_BITS",
    "PE_MULTIPLIERS_4B",
    "throughput_scale",
]

# Width of a unified element in the VRF (Sec. II-C: every adjacent 1, 4 and
# 16 operands are combined into a unified element under 16/8/4-bit modes).
UNIFIED_ELEMENT_BITS = 16 * 16
# Each PE integrates sixteen 4-bit multipliers (Sec. II-B).
PE_MULTIPLIERS_4B = 16


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

    @property
    def ops_per_mac_cycle(self) -> int:
        """Useful INT ops (mul+add = 2) per PE per cycle in this mode."""
        return 2 * self.macs_per_pe


PRECISION_SPECS: dict[Precision, PrecisionSpec] = {
    Precision.INT16: PrecisionSpec(bits=16, ops_per_element=1, macs_per_pe=1, digits=4),
    Precision.INT8: PrecisionSpec(bits=8, ops_per_element=4, macs_per_pe=4, digits=2),
    Precision.INT4: PrecisionSpec(bits=4, ops_per_element=16, macs_per_pe=16, digits=1),
}


def throughput_scale(precision: Precision) -> int:
    """MAC-throughput multiplier of a PE relative to 16-bit mode."""
    return precision.spec.macs_per_pe


def sanity_check() -> None:
    for p, s in PRECISION_SPECS.items():
        assert s.digits * 4 == s.bits, (p, s)  # operands split into 4-bit digits
        # sixteen 4-bit multipliers fully utilized in every mode:
        assert s.digits * s.digits * s.macs_per_pe == PE_MULTIPLIERS_4B, (p, s)


sanity_check()
