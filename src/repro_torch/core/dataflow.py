"""FF / CF / mixed dataflow mapping (paper Sec. II-C).

SPEED schedules a convolution layer onto the SAU with one of two strategies:

  * **FF (feature-map-first)** — pre-fetch a spatial tile of ONE input-channel
    element-group, broadcast it, and sweep the kernel across it.  The halo
    between successive stages (Fig. 2a, blue/red overlap) is reused, so each
    external input element is fetched ~once.  The price: partial sums for the
    whole spatial tile live in the VRF and are written/re-read once per
    input-channel pass ("extra time is wasted in transferring the partial
    results between stages").

  * **CF (channel-first)** — pre-fetch along the input-channel dimension and
    accumulate the channel reduction *inside* the SAU accumulators; no
    partial-sum traffic and a small VRF footprint, but spatial halo is not
    kept, so inputs in the K×K overlap are re-fetched (factor ~(TILE_H+K-1)/
    TILE_H) — harmless for 1×1 kernels, wasteful for large K.

  * **mixed** — per layer, pick whichever the cost model says is faster
    (paper Fig. 3: CF wins conv1x1, FF wins K>=3).

This module produces geometry/traffic statistics (`ScheduleStats`) consumed by
`core/perfmodel.py` (cycles/energy).  Port of ``repro/core/dataflow.py``
(pure Python, copied so the port imports nothing of ``repro``): the same
arithmetic, so the same decisions.  The conv path (`kernels/ops.py::mpconv`
onto the matmul kernels of `kernels/mpmm.py`) maps "CF" to
accumulate-in-register (K-inner) tiling and "FF" to output-stationary
(K-outer) tiling whose partial sums spill to device memory per K stage.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

from repro_torch.core.isa import Dataflow
from repro_torch.core.precision import Precision

__all__ = ["ConvLayer", "HardwareGeometry", "ScheduleStats", "ff_schedule", "cf_schedule", "schedule"]


@dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer (square spatial, as in the paper's benchmarks)."""

    name: str
    cin: int
    cout: int
    k: int
    h: int  # input height
    w: int  # input width
    stride: int = 1
    padding: int = 0

    @property
    def h_out(self) -> int:
        return (self.h + 2 * self.padding - self.k) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w + 2 * self.padding - self.k) // self.stride + 1

    @property
    def macs(self) -> int:
        return self.h_out * self.w_out * self.cout * self.cin * self.k * self.k

    @property
    def ops(self) -> int:
        return 2 * self.macs


@dataclass(frozen=True)
class HardwareGeometry:
    """SAU/lane geometry (paper Sec. III-A experimental setup)."""

    lanes: int = 4
    tile_r: int = 4  # feature-map height parallelism per lane (TILE_H)
    tile_c: int = 4  # output-channel parallelism per lane
    vlen_bits: int = 4096  # VRF register width (same as Ara for fairness)
    n_vregs: int = 32
    op_queue_elems: int = 512  # operand-queue capacity (unified elements)

    @property
    def oc_parallel(self) -> int:
        return self.lanes * self.tile_c

    @property
    def pe_elems_per_cycle(self) -> int:
        """Unified elements the whole processor reduces per cycle."""
        return self.lanes * self.tile_r * self.tile_c

    @property
    def vrf_capacity_bits(self) -> int:
        return self.lanes * self.n_vregs * self.vlen_bits


@dataclass(frozen=True)
class ScheduleStats:
    """Traffic/geometry of one (layer, precision, dataflow) mapping.

    Units: ``elements`` are unified elements (16-bit containers carrying 1/4/16
    operands at 16/8/4-bit); ``values`` are 32-bit partial sums.
    """

    layer: ConvLayer
    precision: Precision
    dataflow: Dataflow
    sau_bursts: int  # element-reductions issued to the SAU (cycles of compute)
    burst_chains: int  # independent accumulate chains (fill/drain events)
    ext_input_elems: int  # unified input elements fetched from external memory
    ext_weight_elems: int  # unified weight elements fetched
    ext_output_values: int  # final outputs written back
    partial_values: int  # partial sums moved VRF<->SAU between stages (FF cost)
    drain_events: int  # accumulator-bank drains (one per output column chain)
    vrf_edge_elems: int  # input elements read VRF->SA edge (port traffic)
    wt_edge_elems: int  # weight elements read VRF->SA edge (queue-cached)
    vrf_peak_bits: int  # peak VRF residency
    vsald_count: int  # number of load instructions issued
    vsam_count: int  # number of arithmetic instructions issued

    @property
    def utilization_denominator(self) -> int:
        return self.sau_bursts


def _ceil(a: int, b: int) -> int:
    return math.ceil(a / b)


@functools.lru_cache(maxsize=None)
def ff_schedule(layer: ConvLayer, precision: Precision, hw: HardwareGeometry = HardwareGeometry()) -> ScheduleStats:
    g = precision.spec.ops_per_element
    ce = _ceil(layer.cin, g)  # input-channel unified elements
    oc_tiles = _ceil(layer.cout, hw.oc_parallel)
    h_tiles = _ceil(layer.h_out, hw.tile_r)
    # Compute: every (output tile row-group, column, oc tile, kernel pos, channel elem)
    sau_bursts = h_tiles * layer.w_out * oc_tiles * layer.k * layer.k * ce
    # Columns stream through the systolic array back-to-back; the pipeline only
    # flushes when the resident weight set changes: per (oc tile, row tile,
    # channel-element stage) under FF.
    burst_chains = h_tiles * oc_tiles * ce
    # Inputs: the spatial sweep keeps the sliding halo resident (one channel
    # strip at a time — tiny), so each input element is fetched once per
    # oc-tile sweep; if ALL channel strips fit simultaneously the image even
    # persists across oc tiles.
    in_elems = _ceil(layer.cin, g) * layer.h * layer.w
    in_space_ops = 8 * hw.vlen_bits // 16  # v0..v7 slab
    all_strip_ops = ce * (hw.tile_r + layer.k - 1) * (layer.w + 2 * layer.padding) * g
    in_refetch = 1 if all_strip_ops <= in_space_ops else oc_tiles
    ext_input_elems = in_elems * in_refetch
    # Weights: fetched once (reused across stages — paper: "Weights are reused
    # in the second stage to minimize off-chip data movement").
    ext_weight_elems = _ceil(layer.cin, g) * layer.cout * layer.k * layer.k
    # Partial sums: spatial-first order => outputs of the whole spatial strip
    # are written to VRF and re-read for each subsequent channel-element pass.
    outputs = layer.h_out * layer.w_out * layer.cout
    partial_values = outputs * max(ce - 1, 0) * 2  # store + reload
    # VRF peak: input spatial tile + partial outputs for the strip.
    strip_outputs_bits = layer.h_out * layer.w_out * min(layer.cout, hw.oc_parallel) * 32
    input_tile_bits = (hw.tile_r + layer.k - 1) * layer.w * 16
    vrf_peak_bits = strip_outputs_bits + input_tile_bits
    drain_events = h_tiles * layer.w_out * oc_tiles  # final-stage drain per column
    # VRF->SA input-edge traffic: FF streams the channel strip once per stage;
    # horizontal window reuse happens inside the systolic array registers.
    w_pad_ff = layer.w + 2 * layer.padding
    vrf_edge_elems = h_tiles * (hw.tile_r + layer.k - 1) * w_pad_ff * ce * oc_tiles
    # weight edge: queue-cached per strip, re-streamed once per stage
    wt_edge_elems = h_tiles * oc_tiles * ce * layer.k * layer.k * hw.oc_parallel
    vsald = oc_tiles * (h_tiles * ce + _ceil(ext_weight_elems, hw.oc_parallel))
    return ScheduleStats(
        layer=layer,
        precision=precision,
        dataflow=Dataflow.FF,
        sau_bursts=sau_bursts,
        burst_chains=burst_chains,
        ext_input_elems=ext_input_elems,
        ext_weight_elems=ext_weight_elems,
        ext_output_values=outputs,
        partial_values=partial_values,
        drain_events=drain_events,
        vrf_edge_elems=vrf_edge_elems,
        wt_edge_elems=wt_edge_elems,
        vrf_peak_bits=vrf_peak_bits,
        vsald_count=vsald,
        vsam_count=sau_bursts,
    )


@functools.lru_cache(maxsize=None)
def cf_schedule(layer: ConvLayer, precision: Precision, hw: HardwareGeometry = HardwareGeometry()) -> ScheduleStats:
    g = precision.spec.ops_per_element
    ce = _ceil(layer.cin, g)
    oc_tiles = _ceil(layer.cout, hw.oc_parallel)
    h_tiles = _ceil(layer.h_out, hw.tile_r)
    sau_bursts = h_tiles * layer.w_out * oc_tiles * layer.k * layer.k * ce
    # CF accumulates the whole reduction (k*k*ce) inside the SAU and the weight
    # set stays resident across the column sweep: one flush per (oc tile, row
    # tile), and no partial-sum traffic at all.
    burst_chains = h_tiles * oc_tiles
    # Inputs: channel-first prefetch trades spatial residency for channel
    # residency.  Three capacity tiers:
    #   (a) the full-width multi-channel row strip fits the input register
    #       space -> horizontal halo reused, only the vertical overlap between
    #       row tiles re-fetches ((tile_r+k-1)/tile_r), and the strip persists
    #       across oc tiles;
    #   (b) only a one-column multi-channel window fits -> CF walks column by
    #       column and the k x k overlap re-fetches both ways
    #       (k * (tile_r+k-1)/tile_r) — THE reason CF loses on large kernels
    #       (paper: "suitable for smaller convolution kernels with low reuse
    #       requirements");
    #   (c) re-streamed per oc tile in either case when not resident.
    w_pad = layer.w + 2 * layer.padding
    in_elems = _ceil(layer.cin, g) * layer.h * layer.w
    in_space_ops = 8 * hw.vlen_bits // 16
    row_window_ops = ce * (hw.tile_r + layer.k - 1) * w_pad * g
    col_window_ops = ce * (hw.tile_r + layer.k - 1) * layer.k * g
    if row_window_ops <= in_space_ops:
        halo_refetch = (hw.tile_r + layer.k - 1) / hw.tile_r
        in_refetch = 1
    elif col_window_ops <= in_space_ops:
        halo_refetch = layer.k * (hw.tile_r + layer.k - 1) / hw.tile_r
        in_refetch = oc_tiles
    else:  # not even one column window resident: full k x k re-fetch
        halo_refetch = float(layer.k * layer.k)
        in_refetch = oc_tiles
    ext_input_elems = math.ceil(in_elems * halo_refetch) * in_refetch
    # Weights: stay VRF-resident across row tiles when the per-oc-tile slice
    # fits the weight register space; otherwise they stream once per row tile.
    w_elems = _ceil(layer.cin, g) * layer.cout * layer.k * layer.k
    w_ops_per_octile = ce * layer.k * layer.k * hw.tile_c * g  # per lane
    w_space_ops = 8 * hw.vlen_bits // 16  # v8..v15 slab
    w_refetch = 1 if w_ops_per_octile <= w_space_ops else h_tiles
    ext_weight_elems = w_elems * w_refetch
    outputs = layer.h_out * layer.w_out * layer.cout
    # VRF peak: ce channel elements for the active positions + weights slice.
    input_bits = ce * (hw.tile_r + layer.k - 1) * (layer.k + 1) * 16
    weight_bits = ce * layer.k * layer.k * hw.oc_parallel * 16
    vrf_peak_bits = input_bits + weight_bits
    drain_events = h_tiles * layer.w_out * oc_tiles
    # VRF->SA input-edge traffic: the per-column multi-channel window is
    # re-read from the VRF for every output column UNLESS it fits the operand
    # queues (paper Fig. 1: "OP Queues", 25% of lane area) — the structural
    # reason CF loses on large kernels even with ample external bandwidth.
    col_window_elems = ce * (hw.tile_r + layer.k - 1) * layer.k
    if col_window_elems <= hw.op_queue_elems:
        vrf_edge_elems = h_tiles * (hw.tile_r + layer.k - 1) * w_pad * ce * oc_tiles
    else:
        vrf_edge_elems = (
            h_tiles * layer.w_out * layer.k * (hw.tile_r + layer.k - 1) * ce * oc_tiles
        )
    wt_edge_elems = h_tiles * oc_tiles * ce * layer.k * layer.k * hw.oc_parallel
    vsald = oc_tiles * h_tiles * (ce + _ceil(w_elems, hw.oc_parallel))
    return ScheduleStats(
        layer=layer,
        precision=precision,
        dataflow=Dataflow.CF,
        sau_bursts=sau_bursts,
        burst_chains=burst_chains,
        ext_input_elems=ext_input_elems,
        ext_weight_elems=ext_weight_elems,
        ext_output_values=outputs,
        partial_values=0,
        drain_events=drain_events,
        vrf_edge_elems=vrf_edge_elems,
        wt_edge_elems=wt_edge_elems,
        vrf_peak_bits=vrf_peak_bits,
        vsald_count=vsald,
        vsam_count=sau_bursts,
    )


def schedule(
    layer: ConvLayer,
    precision: Precision,
    dataflow: Dataflow,
    hw: HardwareGeometry = HardwareGeometry(),
) -> ScheduleStats:
    return (ff_schedule if dataflow is Dataflow.FF else cf_schedule)(layer, precision, hw)
