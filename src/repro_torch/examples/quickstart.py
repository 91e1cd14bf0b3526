"""Quickstart (port of ``examples/quickstart.py``): the paper's technique in
a few minutes.

1. Bit-exact multi-precision arithmetic: a 16-bit MAC out of 4-bit multipliers
2. The custom ISA executing a convolution (FF and CF dataflows)
3. The mixed-dataflow selector on GoogLeNet layers
4. A W4 matmul through the kernel path on float32 activations, the
   dataflow picked by the cycle model's selector, as the JAX example runs
   it: the dequant kernel's float32-activation entry on the card, its plain
   version on the CPU

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core.assembler import assemble_conv
from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.interpreter import run_program
from repro_torch.core.isa import Dataflow, disassemble
from repro_torch.core.perfmodel import evaluate_layer, select_dataflow
from repro_torch.core.precision import Precision
from repro_torch.core.sau import pe_multiply
from repro_torch.device import resolve_device
from repro_torch.kernels import mpmm as mpmm_mod
from repro_torch.kernels import ops

DEMO_LAYER = ConvLayer("demo", cin=8, cout=8, k=3, h=6, w=6, stride=1, padding=1)
SELECTOR_LAYERS = (ConvLayer("conv1x1", 480, 192, 1, 14, 14, 1, 0),
                   ConvLayer("conv3x3", 96, 208, 3, 14, 14, 1, 1))


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: dict = {"device": str(dev)}

    print("== 1. sixteen 4-bit multipliers == one 16-bit multiply ==")
    a, b = -12345, 23456
    got = int(pe_multiply(torch.tensor([a], device=dev), torch.tensor([b], device=dev),
                          Precision.INT16)[0])
    print(f"   {a} * {b} = {got} (direct: {a*b}) bit-exact={got == a*b}")
    out["product"] = got

    print("\n== 2. custom-ISA convolution (VSACFG/VSALD/VSAM) ==")
    rng = np.random.default_rng(0)
    x = rng.integers(-7, 8, (8, 6, 6)).astype(np.int32)
    w = rng.integers(-7, 8, (8, 8, 3, 3)).astype(np.int32)
    out["programs"] = {}
    for df in (Dataflow.FF, Dataflow.CF):
        prog = assemble_conv(DEMO_LAYER, x, w, Precision.INT4, df)
        res = run_program(prog)
        print(f"   {df.name}: {prog.n_instructions} instructions, "
              f"out[0,0,:3]={res[0,0,:3]}")
        out["programs"][df.name] = (prog.n_instructions, [int(v) for v in res[0, 0, :3]])
    first = [disassemble(wd) for wd in prog.words[:3]]
    print("   first instructions:", first)
    out["first_instructions"] = first

    print("\n== 3. mixed dataflow selection (paper Fig. 3) ==")
    out["selector"] = {}
    for layer in SELECTOR_LAYERS:
        df = select_dataflow(layer, Precision.INT16)
        perf = evaluate_layer(layer, Precision.INT16, "mixed")
        print(f"   {layer.name}: selector -> {df.name}, {perf.gops:.1f} GOPS "
              f"({perf.area_eff:.1f} GOPS/mm^2)")
        out["selector"][layer.name] = (df.name, perf.gops, perf.area_eff)

    kernel = "the f32 kernel" if dev.type == "cuda" else "its plain version"
    print(f"\n== 4. multi-precision matmul (W4, f32 activations, {kernel}) ==")
    xf = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32)).to(dev)
    wf = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32)).to(dev)
    wd, ws = ops.pack_weights(wf, 4)
    wrappers = (mpmm_mod.mpmm_cuda, mpmm_mod.mpmm_ff_cuda)
    before = sum(fn.x32_launches for fn in wrappers)
    y = ops.mpmm(xf, wd, ws, w_bits=4, dataflow="auto")
    ref = xf @ wf
    rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
    print(f"   int4 weights: payload {wd.numel()} B (bf16 would be {wf.numel()*2} B), "
          f"rel quant error {rel:.3f}")
    out["mpmm"] = {"payload_bytes": wd.numel(), "rel_err": rel, "y": y.cpu(),
                   "dataflow": ops.select_matmul_dataflow(xf.shape[0], wf.shape[1],
                                                          xf.shape[1]).name,
                   "launches": sum(fn.x32_launches for fn in wrappers) - before}
    print("\nquickstart OK")
    return out


if __name__ == "__main__":
    main()
