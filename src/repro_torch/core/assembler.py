"""Assembler: convolution layer -> SPEED instruction program (port of
``repro/core/assembler.py``, numpy only, over the port's ``core/isa.py`` and
``core/dataflow.py``: the same words for the same layer).

Generates the VSACFG / VSALD / VSAM stream that maps one quantized conv layer
onto the SAU under the FF or CF dataflow (paper Fig. 2), together with the
external-memory image and the metadata a scalar core would supply (base
addresses in ``rs1``).  Programs execute on
:class:`repro_torch.core.interpreter.Machine` and must produce bit-identical
results to a plain integer convolution: that equivalence is the executable
specification of the custom ISA.

Memory / register conventions (documented simplifications of the 5-page
paper's informal spec):

  * External memory is an int32 word array; a *unified element* is ``g``
    consecutive operand words (g = ops_per_element: 1/4/16 at 16/8/4-bit).
  * Input image layout: ``[ce][h_pad][w_pad][g]`` (channel-major elements).
  * Weight layout: ``[ce][ky][kx][oc][g]`` with oc fastest-varying across
    elements so the *ordered* VSALD interleave (element e -> lane e % L)
    deals output channel oc to lane oc % L — output-channel parallelism
    across lanes, as in Sec. II-B.
  * v0..v7: input operand space; v8..v15: weights; v16..v23: FF accumulation
    strips (Acc Addr, lives in the VRF per the paper); v24..v31: CF output
    queue drain space.
  * The operand requester's address generator (Sec. II-B) sweeps the
    per-chain access pattern, so ONE VSAM covers one accumulate chain:
    FF: the (k x k x g) reduction of one output column at the current
    input-channel stage; CF: the full (ce x k x k x g) reduction of one
    output column.  Stage/column counters advance exactly as the lane
    sequencer would (see interpreter).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dataflow import ConvLayer, HardwareGeometry
from repro_torch.core.isa import VSACFG, VSALD, VSAM, Dataflow, Instruction
from repro_torch.core.precision import Precision

__all__ = ["Program", "StoreRec", "assemble_conv"]

V_IN, V_WT, V_ACC, V_OUT = 0, 8, 16, 24


@dataclass(frozen=True)
class StoreRec:
    """Stand-in for the standard RVV store (VSE) draining results to memory:
    after instruction ``pc``, store the [tile_r, w_out, tile_c] strip at
    register ``reg`` to output rows ``row0:row0+rows`` of oc tile ``oc0``."""

    pc: int
    reg: int
    row0: int
    rows: int
    oc0: int


@dataclass
class Program:
    layer: ConvLayer
    precision: Precision
    dataflow: Dataflow
    hw: HardwareGeometry
    words: list[int] = field(default_factory=list)
    rs1_values: dict[int, int] = field(default_factory=dict)  # pc -> base addr
    stores: list[StoreRec] = field(default_factory=list)
    memory: np.ndarray | None = None  # int32 external memory image

    # geometry the scalar core configures via CSRs (not modelled bit-exactly)
    w_pad: int = 0
    h_pad: int = 0
    ce: int = 0

    def emit(self, inst: Instruction, rs1_value: int | None = None) -> int:
        pc = len(self.words)
        self.words.append(inst.encode())
        if rs1_value is not None:
            self.rs1_values[pc] = rs1_value
        return pc

    @property
    def n_instructions(self) -> int:
        return len(self.words)


def _layout_memory(
    layer: ConvLayer, x: np.ndarray, w: np.ndarray, precision: Precision
) -> tuple[np.ndarray, int, int, int, int]:
    """Builds the external-memory image.  ``x``: [cin, h, w] ints,
    ``w``: [cout, cin, k, k] ints.  Returns (memory, input_base, weight_base,
    ce, w_pad)."""
    g = precision.spec.ops_per_element
    p = layer.padding
    cin_pad = math.ceil(layer.cin / g) * g
    ce = cin_pad // g
    h_pad, w_pad = layer.h + 2 * p, layer.w + 2 * p
    xp = np.zeros((cin_pad, h_pad, w_pad), np.int32)
    xp[: layer.cin, p : p + layer.h, p : p + layer.w] = x
    # [ce][h][w][g]
    x_elems = xp.reshape(ce, g, h_pad, w_pad).transpose(0, 2, 3, 1)
    wp = np.zeros((layer.cout, cin_pad, layer.k, layer.k), np.int32)
    wp[:, : layer.cin] = w
    # [ce][ky][kx][oc][g]
    w_elems = wp.reshape(layer.cout, ce, g, layer.k, layer.k).transpose(1, 3, 4, 0, 2)
    mem = np.concatenate([x_elems.reshape(-1), w_elems.reshape(-1)])
    return mem.astype(np.int32), 0, x_elems.size, ce, w_pad


def assemble_conv(
    layer: ConvLayer,
    x: np.ndarray,
    w: np.ndarray,
    precision: Precision,
    dataflow: Dataflow,
    hw: HardwareGeometry | None = None,
) -> Program:
    """Assembles the full instruction program computing ``conv(x, w)`` int32."""
    hw = hw or HardwareGeometry()
    prog = Program(layer=layer, precision=precision, dataflow=dataflow, hw=hw)
    mem, in_base, wt_base, ce, w_pad = _layout_memory(layer, x, w, precision)
    prog.memory = mem
    prog.ce = ce
    prog.w_pad = w_pad
    prog.h_pad = layer.h + 2 * layer.padding
    g = precision.spec.ops_per_element
    k, tr = layer.k, hw.tile_r
    rows_per_load = tr + k - 1
    oc_par = hw.oc_parallel
    oc_tiles = math.ceil(layer.cout / oc_par)
    h_tiles = math.ceil(layer.h_out / tr)
    kernel_hint = min(k, 7)
    w_elems_per_octile = ce * k * k * oc_par  # one g-group element per (ce,ky,kx,oc)

    for ot in range(oc_tiles):
        oc0 = ot * oc_par
        # -- weights for this oc tile: ordered allocation deals oc -> lanes --
        # memory is [ce][ky][kx][oc][g]; slice the oc range via strided copy:
        # for simplicity the assembler materializes the slice contiguously at
        # a staging address (a scalar-core memcpy in a real system).
        stage_base = len(prog.memory)
        n_wt = ce * k * k * layer.cout * g
        wview = prog.memory[wt_base : wt_base + n_wt].reshape(ce, k, k, layer.cout, g)
        blk = wview[:, :, :, oc0 : oc0 + oc_par, :]
        if blk.shape[3] < oc_par:  # ragged last oc tile: zero-pad channels
            pad = np.zeros((ce, k, k, oc_par - blk.shape[3], g), np.int32)
            blk = np.concatenate([blk, pad], axis=3)
        stage = np.ascontiguousarray(blk).reshape(-1)
        prog.memory = np.concatenate([prog.memory, stage])
        prog.emit(
            VSACFG(precision=precision, dataflow=dataflow, kernel_hint=kernel_hint,
                   acc_clear=True, tile_h=tr),
        )
        prog.emit(
            VSALD(vd=V_WT, rs1=1, length=min(w_elems_per_octile, 31), broadcast=False),
            rs1_value=stage_base,
        )
        for ht in range(h_tiles):
            row0 = ht * tr
            rows = min(rows_per_load, prog.h_pad - row0)
            prog.emit(
                VSACFG(precision=precision, dataflow=dataflow,
                       kernel_hint=kernel_hint, acc_clear=True, tile_h=tr)
            )
            if dataflow is Dataflow.FF:
                # stage loop over input-channel elements; partial strip in VRF
                for s in range(ce):
                    base = in_base + (s * prog.h_pad + row0) * w_pad * g
                    prog.emit(
                        VSALD(vd=V_IN, rs1=2, length=min(rows * w_pad, 31), broadcast=True),
                        rs1_value=base,
                    )
                    for _x in range(layer.w_out):
                        prog.emit(VSAM(acc=V_ACC, vs1=V_IN, vs2=V_WT))
                pc = prog.n_instructions - 1
                prog.stores.append(StoreRec(pc=pc, reg=V_ACC, row0=row0,
                                            rows=min(tr, layer.h_out - row0), oc0=oc0))
            else:  # CF: prefetch ALL channel elements, accumulate inside SAU
                base = in_base + row0 * w_pad * g
                prog.emit(
                    VSALD(vd=V_IN, rs1=2, length=min(ce * rows * w_pad, 31), broadcast=True),
                    rs1_value=base,
                )
                for _x in range(layer.w_out):
                    prog.emit(VSAM(acc=V_OUT, vs1=V_IN, vs2=V_WT))
                pc = prog.n_instructions - 1
                prog.stores.append(StoreRec(pc=pc, reg=V_OUT, row0=row0,
                                            rows=min(tr, layer.h_out - row0), oc0=oc0))
    return prog
