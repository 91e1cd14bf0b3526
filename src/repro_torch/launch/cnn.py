"""The paper's own pipeline on the port: quantized CNN inference with the
mixed FF/CF dataflow strategy, printing the per-layer decisions and the
modelled GOPS / area efficiency of the whole network.

    PYTHONPATH=src python -m repro_torch.launch.cnn --net ResNet18 --layers 20

The counterpart of ``examples/cnn_inference_speed.py``, with its flags
(``--net``, ``--w-bits``, ``--layers``) and its output lines, plus
``--device`` (default ``cuda``; with no card present that raises instead of
running on the CPU, so pass ``--device cpu`` to run the kernels' plain
versions).  As in the JAX example, seed 0 draws the random weights and seed
1 the input; both are drawn on the CPU and moved to the device, so a run on
the card and one on the CPU compute on the same numbers.  The first N
layers run numerically on a 1 x 64 x 64 x 3 float32 input, as in the JAX
example: on the card through the dequant kernels' float32-activation
entries, on the CPU through their plain versions.

The "modelled" GOPS and GOPS/mm^2 lines come from the SPEED cycle model
(``core/perfmodel.py``): the paper's 28 nm processor at 500 MHz, not a
measurement of the card or of any other device.  ``--w-bits 4`` raises
``ValueError`` for every network, as the JAX example does: the first conv's
K = cin*k*k is odd, and int4 packs K in pairs.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.models.cnn_zoo import BENCHMARK_NETWORKS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="SqueezeNet", choices=list(BENCHMARK_NETWORKS))
    ap.add_argument("--w-bits", type=int, default=8, choices=[4, 8])
    ap.add_argument("--layers", type=int, default=6, help="execute first N layers numerically")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.core.perfmodel import SpeedModel, evaluate_network
    from repro_torch.core.precision import Precision
    from repro_torch.device import resolve_device
    from repro_torch.models.cnn import init_network, run_network

    device = resolve_device(args.device)
    layers, params = init_network(args.net, 0, w_bits=args.w_bits, device="cpu")
    params = [(wd.to(device), ws.to(device)) for wd, ws in params]
    print(f"{args.net}: {len(layers)} conv layers, w{args.w_bits} quantized")

    # numerics on a downscaled input through the first N layers
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(device)
    out, decisions = run_network(
        args.net, x, params[: args.layers], layers[: args.layers], w_bits=args.w_bits,
        device=device,
    )
    finite = bool(torch.isfinite(out).all())
    print(f"executed {args.layers} layers -> activation {tuple(out.shape)}, "
          f"finite={finite}")
    print("dataflow decisions:")
    for d in decisions:
        print("   ", d)

    # full-network modelled efficiency (the paper's metric, SPEED's cycle model)
    modelled = {}
    for prec in (Precision.INT16, Precision.INT8, Precision.INT4):
        r = evaluate_network(layers, prec, "mixed", SpeedModel())
        modelled[prec.name] = {"gops": r["gops"], "area_eff": r["area_eff"]}
        print(f"modelled {prec.name}: {r['gops']:.1f} GOPS, "
              f"{r['area_eff']:.1f} GOPS/mm^2")
    return {"net": args.net, "device": str(device), "shape": tuple(out.shape),
            "dtype": str(out.dtype), "finite": finite, "decisions": decisions,
            "modelled": modelled, "activation": out}


if __name__ == "__main__":
    main()
