"""Functional simulator for SPEED's custom-instruction programs (port of
``repro/core/interpreter.py``: numpy, int64 accumulation; ``bit_accurate``
products go through the port's ``core/sau.py``).

Executes the instruction stream emitted by :mod:`repro_torch.core.assembler`
against an architectural model: external memory, per-lane vector register
files, the SAU, and the lane-sequencer counters.  The output of a program
must equal the plain convolution oracle: this is the executable
specification of the ISA semantics (held against the JAX package by
tests/test_torch_core.py, across precisions, dataflows and kernel sizes).

Microarchitectural conventions (see assembler docstring for layouts):

  * VRF: 32 vector registers x VLEN=4096 bits per lane; modelled as int32
    operand slots (256 x 16-bit operands per register).  Register *spaces*
    (8 registers each) form contiguous slabs: inputs v0-, weights v8-,
    FF accumulation strips v16- (the paper's "Acc Addr" lives in the VRF),
    CF output-queue drain space v24-.
  * The operand requester's address generator (paper Sec. II-B: "an address
    generator and a request arbiter") sweeps one *accumulate chain* per VSAM:
    the (k*k*g) reduction of one output column for the current input-channel
    stage under FF, or the full (ce*k*k*g) reduction under CF (accumulating
    in the SAU, results drained through the output queue).
  * The lane sequencer keeps a column counter (advanced per VSAM, reset by
    VSALD/VSACFG) and an input-stage counter (advanced per broadcast VSALD,
    reset by VSACFG) — the auto-increment state a systolic sequencer tracks.
  * Transfer lengths/strides come from the layer geometry the scalar core
    programs via CSRs; the 5-bit ``length`` field in VSALD is a debug hint
    (as in RVV, where the real vector length lives in ``vl``/``vtype`` CSRs,
    not in the instruction word).

The simulator is numpy-based (bit-accurate int64 accumulation); the
``bit_accurate`` flag additionally routes every product through the 4-bit
digit decomposition of :func:`repro.core.sau.pe_multiply`, proving the
multi-precision multiplier-combination identity end-to-end.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import sau as sau_mod
from repro_torch.core.assembler import Program, V_ACC, V_IN, V_WT
from repro_torch.core.isa import VSACFG, VSALD, VSAM, Dataflow, decode

__all__ = ["Machine", "run_program"]

_REG_OPS = 256  # 4096-bit register / 16-bit operand slots
_SLAB_REGS = 8


@dataclass
class Machine:
    program: Program
    bit_accurate: bool = False

    # architectural state
    vrf: np.ndarray = field(init=False)  # [lanes, 32, 256] int32 operand slots
    cfg: VSACFG = field(init=False)
    col: int = 0
    stage: int = 0
    in_shape: tuple[int, ...] = ()  # shape of the last input load (per lane)

    def __post_init__(self) -> None:
        hw = self.program.hw
        self.vrf = np.zeros((hw.lanes, 32, _REG_OPS), np.int32)
        self.cfg = VSACFG()

    # -- register-space helpers ---------------------------------------------
    def _slab(self, reg: int) -> np.ndarray:
        """Contiguous view of the 8-register space starting at ``reg``."""
        return self.vrf[:, reg : reg + _SLAB_REGS].reshape(self.program.hw.lanes, -1)

    def _write_slab(self, reg: int, lane_data: np.ndarray) -> None:
        slab = self._slab(reg)
        n = lane_data.shape[-1]
        if n > slab.shape[-1]:
            raise RuntimeError(
                f"VRF overflow: load of {n} operands exceeds register space "
                f"({slab.shape[-1]}) at v{reg}"
            )
        slab[:, :n] = lane_data
        slab[:, n:] = 0

    # -- instruction semantics ------------------------------------------------
    def _exec_cfg(self, inst: VSACFG) -> None:
        self.cfg = inst
        self.col = 0
        self.stage = 0
        if inst.acc_clear:
            self.vrf[:, V_ACC:] = 0

    def _exec_load(self, inst: VSALD, base: int) -> None:
        prog, hw = self.program, self.program.hw
        mem = prog.memory
        g = self.cfg.precision.spec.ops_per_element
        k = self.cfg.kernel_hint
        tr = self.cfg.tile_h
        if inst.vd == V_WT:
            # ordered allocation: element e -> lane e % lanes (weights)
            ce, oc_par = prog.ce, hw.oc_parallel
            n_elems = ce * k * k * oc_par
            data = mem[base : base + n_elems * g].reshape(n_elems, g)
            per_lane = np.stack(
                [data[l :: hw.lanes].reshape(-1) for l in range(hw.lanes)]
            )
            self._write_slab(V_WT, per_lane)
            return
        # broadcast input load; geometry-driven 2-D pattern
        w_pad, h_pad = prog.w_pad, prog.h_pad
        rows_full = tr + k - 1
        plane = h_pad * w_pad * g
        row0 = (base - 0) % plane // (w_pad * g) if plane else 0
        rows_avail = min(rows_full, h_pad - row0)
        if self.cfg.dataflow is Dataflow.CF:
            # gather the same row window from every channel plane
            ce = prog.ce
            chunk = np.zeros((ce, rows_full, w_pad, g), np.int32)
            for s in range(ce):
                src = mem[base + s * plane : base + s * plane + rows_avail * w_pad * g]
                chunk[s, :rows_avail] = src.reshape(rows_avail, w_pad, g)
            self.in_shape = chunk.shape
        else:
            chunk = np.zeros((rows_full, w_pad, g), np.int32)
            src = mem[base : base + rows_avail * w_pad * g]
            chunk[:rows_avail] = src.reshape(rows_avail, w_pad, g)
            self.in_shape = chunk.shape
            self.stage += 1
        flat = chunk.reshape(-1)
        self._write_slab(V_IN, np.broadcast_to(flat, (hw.lanes, flat.size)))
        self.col = 0

    def _products(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Element products, optionally through the 4-bit digit identity
        (the port's ``sau.pe_multiply``, on the CPU)."""
        if self.bit_accurate:
            p = sau_mod.pe_multiply(torch.from_numpy(np.ascontiguousarray(a)),
                                    torch.from_numpy(np.ascontiguousarray(b)),
                                    self.cfg.precision)
            return p.numpy().astype(np.int64)
        return a.astype(np.int64) * b.astype(np.int64)

    def _exec_mac(self, inst: VSAM) -> None:
        prog, hw = self.program, self.program.hw
        g = self.cfg.precision.spec.ops_per_element
        k, tr, tc = self.cfg.kernel_hint, self.cfg.tile_h, hw.tile_c
        ce = prog.ce
        w_out = prog.layer.w_out
        x = self.col
        self.col += 1
        wts = self._slab(V_WT)[:, : ce * k * k * tc * g].reshape(
            hw.lanes, ce, k, k, tc, g
        )
        if self.cfg.dataflow is Dataflow.FF:
            s = self.stage - 1
            inp = self._slab(V_IN)[0, : int(np.prod(self.in_shape))].reshape(self.in_shape)
            # windows: [tr, k, k, g] for output column x
            win = np.stack(
                [inp[r : r + k, x : x + k, :] for r in range(tr)]
            )  # [tr,k,k,g]
            prod = self._products(win[None, :, :, :, None, :], wts[:, s][:, None, :, :, :, :])
            contrib = prod.sum(axis=(2, 3, 5))  # [lanes, tr, tc]
            strip = self._slab(inst.acc)[:, : tr * w_out * tc].reshape(
                hw.lanes, tr, w_out, tc
            )
            strip[:, :, x, :] = (strip[:, :, x, :].astype(np.int64) + contrib).astype(
                np.int32
            )
        else:  # CF: full reduction inside the SAU, drain via output queue
            inp = self._slab(V_IN)[0, : int(np.prod(self.in_shape))].reshape(self.in_shape)
            win = np.stack(
                [inp[:, r : r + k, x : x + k, :] for r in range(tr)], axis=1
            )  # [ce, tr, k, k, g]
            prod = self._products(
                win[None, :, :, :, :, None, :], wts[:, :, None, :, :, :, :]
            )  # [lanes, ce, tr, k, k, tc, g]
            out = prod.sum(axis=(1, 3, 4, 6))  # [lanes, tr, tc]
            strip = self._slab(inst.acc)[:, : tr * w_out * tc].reshape(
                hw.lanes, tr, w_out, tc
            )
            strip[:, :, x, :] = out.astype(np.int32)

    # -- the run loop ---------------------------------------------------------
    def run(self) -> np.ndarray:
        prog, hw = self.program, self.program.hw
        layer = prog.layer
        out = np.zeros((layer.cout, layer.h_out, layer.w_out), np.int64)
        stores = {s.pc: s for s in prog.stores}
        for pc, word in enumerate(prog.words):
            inst = decode(word)
            if isinstance(inst, VSACFG):
                self._exec_cfg(inst)
            elif isinstance(inst, VSALD):
                self._exec_load(inst, prog.rs1_values[pc])
            elif isinstance(inst, VSAM):
                self._exec_mac(inst)
            if pc in stores:
                st = stores[pc]
                tr, tc = self.cfg.tile_h, hw.tile_c
                strip = self._slab(st.reg)[:, : tr * layer.w_out * tc].reshape(
                    hw.lanes, tr, layer.w_out, tc
                )
                for l in range(hw.lanes):
                    for j in range(tc):
                        oc = st.oc0 + l + hw.lanes * j
                        if oc < layer.cout:
                            out[oc, st.row0 : st.row0 + st.rows, :] = strip[
                                l, : st.rows, :, j
                            ]
        return out


def run_program(program: Program, bit_accurate: bool = False) -> np.ndarray:
    return Machine(program, bit_accurate=bit_accurate).run()
