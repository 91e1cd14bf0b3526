"""Analytical cycle / area / energy model of SPEED and the Ara baseline.

The paper evaluates SPEED with cycle-accurate QuestaSim simulation of the RTL
plus Synopsys DC synthesis at TSMC 28nm (Sec. III-A).  We have no RTL here;
instead this module is a calibrated analytical model that

  * converts `core.dataflow.ScheduleStats` into cycle counts using a small set
    of microarchitectural parameters (external-memory bandwidth, VRF port
    bandwidth, systolic fill/drain, issue overhead, load/compute overlap),
  * applies the synthesized constants the paper reports (area, power,
    frequency — Table I) to produce GOPS, GOPS/mm^2 and GOPS/W,
  * implements the same for Ara (the paper's baseline): no 4-bit mode, no
    broadcast loads, no in-SAU accumulation (vmacc over an output-stationary
    vector register), k^2 input re-fetch for convolution windows.

Calibration: the free microarchitectural parameters are fitted once against
the paper's own reported numbers (Table I peaks + Fig. 3/4 ratios) by
``benchmarks/calibrate.py``; the fitted values are frozen below and the
benchmark harness reports both our model's numbers and the paper's alongside
the relative error.  The *qualitative* claims (CF wins 1x1, FF wins K>=3,
mixed > either, SPEED >> Ara, 4-bit ~3x 8-bit) are model outputs, not inputs.

Port of ``repro/core/perfmodel.py`` (pure Python, copied so the port imports
nothing of ``repro``).  Its numbers are the modelled 28 nm SPEED figures of
the paper's setup, not measurements of any card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.dataflow import (
    ConvLayer,
    HardwareGeometry,
    ScheduleStats,
    cf_schedule,
    ff_schedule,
)
from repro_torch.core.isa import Dataflow
from repro_torch.core.precision import Precision

__all__ = [
    "SpeedModel",
    "AraModel",
    "LayerPerf",
    "select_dataflow",
    "evaluate_layer",
    "evaluate_network",
]


@dataclass(frozen=True)
class LayerPerf:
    layer: ConvLayer
    precision: Precision
    dataflow: Dataflow | None  # None for Ara (single fixed dataflow)
    cycles: float
    gops: float
    area_eff: float  # GOPS / mm^2
    energy_eff: float  # GOPS / W
    utilization: float


@dataclass(frozen=True)
class SpeedModel:
    """SPEED @ TSMC 28nm, 500 MHz, 4 lanes, TILE_R=TILE_C=4, VLEN=4096 (Sec. III-A)."""

    hw: HardwareGeometry = HardwareGeometry()
    freq_hz: float = 500e6
    area_mm2: float = 1.10  # Table I (synthesis constant)
    power_w: float = 0.21516  # Table I (synthesis constant)

    # --- fitted microarchitecture parameters (benchmarks/calibrate.py;
    #     frozen 2026-07-15, loss 3.38 — per-metric errors in EXPERIMENTS.md) ---
    ext_bw_bits: float = 21.722  # external-memory bits / cycle (AXI-like bus)
    vrf_bw_values: float = 11.967  # 32-bit partial sums / cycle VRF<->SAU
    out_bw_values: float = 47.486  # final outputs / cycle writeback
    chain_bubble: float = 0.0  # pipeline bubble when an accumulate chain retires
    issue_cycles: float = 0.0  # sequencer/issue cost per vector instruction
    overlap: float = 0.858  # fraction of load/transfer hidden under compute
    sau_eff: float = 0.575  # operand-requester arbitration / VRF bank-conflict
    #                        efficiency: average fraction of cycles the SA core
    #                        accepts a new unified element (request arbiter,
    #                        Sec. II-B, serializes colliding VRF reads)
    vrf_read_bits: float = 1990.881  # VRF read-port bits / lane / cycle feeding
    #                               the SAU edges: narrow precisions move wider
    #                               unified elements (64-bit at 4-bit mode), so
    #                               the port width caps narrow-mode throughput
    layer_startup: float = 29090.192  # per-layer fixed cost: scalar-core setup,
    #                                first-fetch latency, pipeline warm-up/drain
    col_drain: float = 15.065  # accumulator drain bubble per output-column chain
    #                         (single accumulator bank per PE: the systolic
    #                         drain serializes against the next column's fill;
    #                         negligible for long chains, dominant for the
    #                         short chains of 4-bit / small-ce layers)

    def peak_gops(self, precision: Precision) -> float:
        return (
            self.hw.pe_elems_per_cycle
            * precision.spec.ops_per_mac_cycle
            * self.freq_hz
            / 1e9
        )

    def cycles(self, stats: ScheduleStats) -> float:
        # a unified element is g operands of `bits` width: 16/32/64 bits at
        # 16/8/4-bit precision — narrower ops move MORE operands per element
        # but each element costs more port/bus beats.
        spec = stats.precision.spec
        elem_bits = spec.ops_per_element * spec.bits
        # VRF read-port limit: the SA edges consume operand traffic
        # (vrf_edge_elems + wt_edge_elems) through per-lane read ports of
        # vrf_read_bits/cycle; wide (narrow-precision) elements can make the
        # ports, not the MXU-equivalent array, the binding constraint.
        hw = self.hw
        port_bits = (stats.vrf_edge_elems + stats.wt_edge_elems) * elem_bits
        port_cycles = port_bits / (hw.lanes * self.vrf_read_bits)
        compute = (
            max(stats.sau_bursts / self.sau_eff, port_cycles)
            + self.chain_bubble * stats.burst_chains
            + self.col_drain * stats.drain_events
        )
        load_bits = (stats.ext_input_elems + stats.ext_weight_elems) * elem_bits
        loads = load_bits / self.ext_bw_bits
        transfers = stats.partial_values / self.vrf_bw_values
        writeback = stats.ext_output_values / self.out_bw_values
        issue = self.issue_cycles * (stats.vsald_count + stats.vsam_count / 64.0)
        noncompute = loads + transfers + writeback
        # A fraction `overlap` of non-compute work hides under the SAU bursts.
        hidden = min(noncompute * self.overlap, compute * 0.95)
        return compute + noncompute - hidden + issue + self.layer_startup

    def evaluate(self, layer: ConvLayer, precision: Precision, dataflow: Dataflow) -> LayerPerf:
        stats = (ff_schedule if dataflow is Dataflow.FF else cf_schedule)(layer, precision, self.hw)
        cyc = self.cycles(stats)
        t = cyc / self.freq_hz
        gops = layer.ops / t / 1e9
        return LayerPerf(
            layer=layer,
            precision=precision,
            dataflow=dataflow,
            cycles=cyc,
            gops=gops,
            area_eff=gops / self.area_mm2,
            energy_eff=gops / self.power_w,
            utilization=gops / self.peak_gops(precision),
        )


@dataclass(frozen=True)
class AraModel:
    """Ara baseline (Table I column 1): RVV 1.0, 4 lanes, VLEN=4096, 500 MHz.

    Ara has 64-bit SIMD MAC datapaths per lane: 4x16-bit or 8x8-bit MACs per
    lane per cycle; no 4-bit support, no broadcast loads (each lane receives
    its ordered slice, so convolution windows re-fetch inputs ~k^2 times via
    strided/slide operations), and channel reductions accumulate through
    vector registers (vmacc), costing a read-modify-write per element.
    """

    lanes: int = 4
    freq_hz: float = 500e6
    area_mm2: float = 0.44  # Table I
    power_w: float = 0.06114  # Table I

    # --- fitted parameters (frozen with the SpeedModel fit) ---
    ext_bw_bits: float = 16.0  # external-memory bits / cycle
    slide_penalty: float = 6.0  # strided-window overhead factor on loads
    issue_cycles: float = 63.713
    overlap: float = 0.1  # in-order core hides less of the load latency
    layer_startup: float = 29863.069  # per-layer vsetvl/strip-mining fixed cost
    w16_penalty: float = 1.457  # RVV widening MAC (vwmacc, EMUL=2 destination)
    #                           throughput penalty: 16-bit MACs accumulate into
    #                           32-bit vd, halving effective SIMD rate; 8-bit
    #                           convs accumulate in 16-bit and re-widen rarely.

    def simd_macs(self, precision: Precision) -> float:
        if precision is Precision.INT4:
            raise ValueError("Ara has no 4-bit integer mode (Table I)")
        base = self.lanes * (64 // precision.spec.bits)
        if precision is Precision.INT16:
            return base / self.w16_penalty
        return base

    def peak_gops(self, precision: Precision) -> float:
        return self.simd_macs(precision) * 2 * self.freq_hz / 1e9

    def evaluate(self, layer: ConvLayer, precision: Precision) -> LayerPerf:
        macs = layer.macs
        compute = macs / self.simd_macs(precision)
        # vmacc accumulation: partial sums live in a vector register and are
        # re-read/written every channel step => an extra register pass per MAC
        # group, modelled as 1 extra cycle per SIMD group per k*k*cin step is
        # already inside compute; the dominant extra is data movement:
        in_bits = layer.cin * layer.h * layer.w * precision.spec.bits
        # no broadcast + window slides: inputs re-fetched ~k (vertical reuse
        # via slides exists, horizontal does not) x oc-tile sweeps
        oc_passes = math.ceil(layer.cout / (self.lanes * 4))
        load_bits = in_bits * layer.k * self.slide_penalty * oc_passes
        w_bits = layer.cout * layer.cin * layer.k * layer.k * precision.spec.bits
        out_bits = layer.h_out * layer.w_out * layer.cout * 32
        loads = (load_bits + w_bits + out_bits) / self.ext_bw_bits
        # instruction issue: one vmacc per (k*k*cin) per output strip
        n_instr = layer.k * layer.k * layer.cin * math.ceil(layer.h_out * layer.w_out / 256) * oc_passes
        issue = self.issue_cycles * n_instr / 8.0
        hidden = min(loads * self.overlap, compute * 0.95)
        cyc = compute + loads - hidden + issue + self.layer_startup
        t = cyc / self.freq_hz
        gops = layer.ops / t / 1e9
        return LayerPerf(
            layer=layer,
            precision=precision,
            dataflow=None,
            cycles=cyc,
            gops=gops,
            area_eff=gops / self.area_mm2,
            energy_eff=gops / self.power_w,
            utilization=gops / self.peak_gops(precision),
        )


def select_dataflow(
    layer: ConvLayer, precision: Precision, model: SpeedModel | None = None
) -> Dataflow:
    """The paper's *mixed* strategy: per layer, pick the faster dataflow."""
    model = model or SpeedModel()
    ff = model.evaluate(layer, precision, Dataflow.FF)
    cf = model.evaluate(layer, precision, Dataflow.CF)
    return Dataflow.FF if ff.cycles <= cf.cycles else Dataflow.CF


def evaluate_layer(
    layer: ConvLayer,
    precision: Precision,
    strategy: str = "mixed",
    model: SpeedModel | None = None,
) -> LayerPerf:
    model = model or SpeedModel()
    if strategy == "ff":
        return model.evaluate(layer, precision, Dataflow.FF)
    if strategy == "cf":
        return model.evaluate(layer, precision, Dataflow.CF)
    if strategy == "mixed":
        df = select_dataflow(layer, precision, model)
        return model.evaluate(layer, precision, df)
    raise ValueError(f"unknown strategy {strategy!r}")


def evaluate_network(
    layers: list[ConvLayer],
    precision: Precision,
    strategy: str = "mixed",
    model: SpeedModel | None = None,
) -> dict:
    """Network-level metrics the paper reports: total-ops / total-time GOPS
    (equivalently, cycle-weighted) and the derived efficiencies."""
    model = model or SpeedModel()
    perfs = [evaluate_layer(l, precision, strategy, model) for l in layers]
    total_ops = sum(p.layer.ops for p in perfs)
    total_cycles = sum(p.cycles for p in perfs)
    gops = total_ops / (total_cycles / model.freq_hz) / 1e9
    return {
        "layers": perfs,
        "gops": gops,
        "area_eff": gops / model.area_mm2,
        "energy_eff": gops / model.power_w,
        "peak_layer_gops": max(p.gops for p in perfs),
        "total_cycles": total_cycles,
    }


def evaluate_network_ara(
    layers: list[ConvLayer], precision: Precision, model: AraModel | None = None
) -> dict:
    model = model or AraModel()
    perfs = [model.evaluate(l, precision) for l in layers]
    total_ops = sum(p.layer.ops for p in perfs)
    total_cycles = sum(p.cycles for p in perfs)
    gops = total_ops / (total_cycles / model.freq_hz) / 1e9
    return {
        "layers": perfs,
        "gops": gops,
        "area_eff": gops / model.area_mm2,
        "energy_eff": gops / model.power_w,
        "peak_layer_gops": max(p.gops for p in perfs),
        "total_cycles": total_cycles,
    }
