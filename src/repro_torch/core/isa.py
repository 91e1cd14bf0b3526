"""SPEED's customized RISC-V vector instructions (paper Sec. II-A, Fig. 1).

Port of ``repro/core/isa.py`` (pure Python, copied so the port imports
nothing of ``repro``); encodings are identical.

Three customized instructions extend RVV 1.0:

  * ``VSACFG`` — configuration-setting: precision (4~16-bit) + dataflow
    strategy (FF/CF) + tile geometry, carried in the ``zimm9``/``uimm5``
    immediate spaces (mirroring ``vsetivli``'s encoding style).
  * ``VSALD`` — customized load: loads from external memory base address
    (``rs1``) into the VRFs at destination ``vd``; the ``mop`` bit selects
    *broadcast* distribution (same data to every lane — SPEED's reuse trick)
    vs the standard *ordered* allocation of ``VLE``.
  * ``VSAM``  — customized arithmetic: systolic multiply-accumulate; operands
    at VRF addresses ``vs1``/``vs2``, result accumulated at ``Acc Addr``.

The paper names the fields but (as a 5-page ISCAS paper) does not publish bit
positions; we fix a concrete encoding in the RVV style below and keep it
round-trip tested.  Encodings use the OP-V major opcode (0x57) with funct3 =
0b111 (the vsetvl family slot) for VSACFG and the custom-1 major opcode
(0x2B) for VSALD/VSAM, so they do not collide with standard RVV instructions.

Layouts (bit 31 .. bit 0):

VSACFG  [31]=1 [30]=1 | zimm9[28:20] | uimm5[19:15] | funct3=111 | rd[11:7] | opcode=1010111
  zimm9 = {reserved[8:6], acc_clear[5], kernel_hint[4:2], dataflow[1], sew[0]}
          is 9 bits:  sew(2) precision, dataflow(1), kernel_hint(3), acc_clear(1), rsvd(2)
  uimm5 = TILE_H (feature-map rows mapped per SAU pass)

VSALD   nf[31:29]=0 | mop[28]=broadcast | rs2/len[24:20] | rs1[19:15] |
        funct3=111 | vd[11:7] | opcode=0101011
VSAM    funct7[31:25]=0b0000001 | vs2[24:20] | vs1[19:15] | funct3=000 |
        acc[11:7] | opcode=0101011
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union

from repro_torch.core.precision import Precision

__all__ = [
    "Dataflow",
    "VSACFG",
    "VSALD",
    "VSAM",
    "Instruction",
    "encode",
    "decode",
    "OPCODE_OP_V",
    "OPCODE_CUSTOM1",
]

OPCODE_OP_V = 0b1010111  # 0x57
OPCODE_CUSTOM1 = 0b0101011  # 0x2B
_FUNCT3_CFG = 0b111
_FUNCT3_LD = 0b111
_FUNCT3_AM = 0b000
_FUNCT7_AM = 0b0000001

_SEW_TO_PRECISION = {0b00: Precision.INT16, 0b01: Precision.INT8, 0b10: Precision.INT4}
_PRECISION_TO_SEW = {v: k for k, v in _SEW_TO_PRECISION.items()}


class Dataflow(enum.IntEnum):
    """Dataflow strategy selected by VSACFG (paper Sec. II-C)."""

    FF = 0  # feature-map-first: spatial tile stationary, halo reuse
    CF = 1  # channel-first: accumulate along input channels inside the SAU


def _field(value: int, width: int, name: str) -> int:
    if not 0 <= value < (1 << width):
        raise ValueError(f"{name}={value} does not fit in {width} bits")
    return value


@dataclass(frozen=True)
class VSACFG:
    """vsacfg rd, zimm9, uimm5 — configure precision/dataflow/tiling."""

    precision: Precision = Precision.INT8
    dataflow: Dataflow = Dataflow.CF
    kernel_hint: int = 0  # log2-ish kernel-size hint for the selector, 3 bits
    acc_clear: bool = True  # clear SAU accumulators at next VSAM burst
    tile_h: int = 4  # uimm5
    rd: int = 0

    @property
    def zimm9(self) -> int:
        sew = _PRECISION_TO_SEW[self.precision]
        return (
            (_field(sew, 2, "sew"))
            | (_field(int(self.dataflow), 1, "dataflow") << 2)
            | (_field(self.kernel_hint, 3, "kernel_hint") << 3)
            | (_field(int(self.acc_clear), 1, "acc_clear") << 6)
        )

    def encode(self) -> int:
        return (
            (1 << 31)
            | (1 << 30)
            | (_field(self.zimm9, 9, "zimm9") << 20)
            | (_field(self.tile_h, 5, "uimm5") << 15)
            | (_FUNCT3_CFG << 12)
            | (_field(self.rd, 5, "rd") << 7)
            | OPCODE_OP_V
        )


@dataclass(frozen=True)
class VSALD:
    """vsald vd, (rs1), len — load from external-memory base ``rs1`` into the
    VRF at ``vd``; broadcast to all lanes when ``broadcast`` else ordered."""

    vd: int
    rs1: int
    length: int = 0  # rs2/len field: number of unified elements (0 => VL)
    broadcast: bool = True

    def encode(self) -> int:
        return (
            (_field(int(self.broadcast), 1, "mop") << 28)
            | (_field(self.length, 5, "len") << 20)
            | (_field(self.rs1, 5, "rs1") << 15)
            | (_FUNCT3_LD << 12)
            | (_field(self.vd, 5, "vd") << 7)
            | OPCODE_CUSTOM1
        )


@dataclass(frozen=True)
class VSAM:
    """vsam acc, vs1, vs2 — systolic MAC: acc[...] += VRF[vs1] @ VRF[vs2]."""

    acc: int  # Acc Addr in VRF
    vs1: int  # inputs base
    vs2: int  # weights base

    def encode(self) -> int:
        return (
            (_FUNCT7_AM << 25)
            | (_field(self.vs2, 5, "vs2") << 20)
            | (_field(self.vs1, 5, "vs1") << 15)
            | (_FUNCT3_AM << 12)
            | (_field(self.acc, 5, "acc") << 7)
            | OPCODE_CUSTOM1
        )


Instruction = Union[VSACFG, VSALD, VSAM]


def encode(inst: Instruction) -> int:
    return inst.encode()


def decode(word: int) -> Instruction:
    if not 0 <= word < (1 << 32):
        raise ValueError("instruction word must be 32-bit")
    opcode = word & 0x7F
    funct3 = (word >> 12) & 0x7
    if opcode == OPCODE_OP_V and funct3 == _FUNCT3_CFG and (word >> 30) & 0x3 == 0b11:
        zimm9 = (word >> 20) & 0x1FF
        sew = zimm9 & 0x3
        if sew not in _SEW_TO_PRECISION:
            raise ValueError(f"reserved sew encoding {sew:#b}")
        return VSACFG(
            precision=_SEW_TO_PRECISION[sew],
            dataflow=Dataflow((zimm9 >> 2) & 0x1),
            kernel_hint=(zimm9 >> 3) & 0x7,
            acc_clear=bool((zimm9 >> 6) & 0x1),
            tile_h=(word >> 15) & 0x1F,
            rd=(word >> 7) & 0x1F,
        )
    if opcode == OPCODE_CUSTOM1 and funct3 == _FUNCT3_LD:
        return VSALD(
            vd=(word >> 7) & 0x1F,
            rs1=(word >> 15) & 0x1F,
            length=(word >> 20) & 0x1F,
            broadcast=bool((word >> 28) & 0x1),
        )
    if opcode == OPCODE_CUSTOM1 and funct3 == _FUNCT3_AM and (word >> 25) == _FUNCT7_AM:
        return VSAM(
            acc=(word >> 7) & 0x1F,
            vs1=(word >> 15) & 0x1F,
            vs2=(word >> 20) & 0x1F,
        )
    raise ValueError(f"not a SPEED custom instruction: {word:#010x}")


def disassemble(word: int) -> str:
    inst = decode(word)
    if isinstance(inst, VSACFG):
        return (
            f"vsacfg x{inst.rd}, e{inst.precision.value}, "
            f"{inst.dataflow.name.lower()}, kh{inst.kernel_hint}, th{inst.tile_h}"
            + (", clr" if inst.acc_clear else "")
        )
    if isinstance(inst, VSALD):
        mode = "bcast" if inst.broadcast else "ord"
        return f"vsald v{inst.vd}, (x{inst.rs1}), n{inst.length}, {mode}"
    return f"vsam v{inst.acc}, v{inst.vs1}, v{inst.vs2}"
