#!/usr/bin/env python3
"""Times the CF dequant matmul's tensor-core kernel (src/repro_torch/kernels/
csrc/mpmm.cu) under every launch plan it takes at a list of shapes, beside the
plan ``kernels/mpmm.py::launch_plan`` picks and PyTorch's bf16 matmul on the
pre-dequantized weights.  Needs one CUDA card:

    python3 tools/sweep_mpmm_plans.py > sweep.jsonl

One JSON line per shape: every (block_m, splits) with its median time in ms
(CUDA events, L2 flushed before each launch, as chip_smoke.py times), the
chosen plan's time and the fastest.  Plans are launched through the C entry
point with the weights in w8.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = [  # (M, K, N): llama3.2-3b projections at M 128 / 256, ResNet18's CF
    # layers at batch 8, zamba2-7b's in_proj at its prefill M
    (128, 3072, 3072), (128, 3072, 1024), (128, 3072, 8192), (128, 8192, 3072),
    (256, 3072, 3072), (256, 3072, 1024), (256, 8192, 3072), (256, 3072, 8192),
    (392, 256, 512), (1568, 128, 256), (6272, 64, 128), (4096, 3584, 14576),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_mpmm_plans: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build, mpmm, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    lib = _build.lib()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, iters=10):
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES:
        wd, ws = ops.pack_weights(torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k), 8)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w_deq = (wd.float() * ws).to(torch.bfloat16)
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        steps = -(-k // mpmm.TC_BK)
        plan = mpmm.launch_plan(m, n, k)
        chosen = (plan["block_m"], plan["splits"])
        cands = {chosen: plan["k_per_split"]}
        for bm in mpmm.TC_BLOCK_M:
            for want in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24):
                if want <= steps:
                    per = -(-steps // want) * mpmm.TC_BK
                    cands.setdefault((bm, -(-k // per)), per)
        times = {}
        for (bm, splits), per in cands.items():
            part = torch.empty(splits, m, n, device="cuda") if splits > 1 else out

            def run():
                err = lib.mpmm_dequant_bf16(
                    x.data_ptr(), wd.data_ptr(), ws.data_ptr(), out.data_ptr(),
                    part.data_ptr(), m, n, k, 8, splits, per, bm, stream)
                if err:
                    raise RuntimeError(f"mpmm_dequant_bf16: CUDA error {err}")
            times[(bm, splits)] = timed(run)
        best = min(times, key=times.get)
        print(json.dumps({
            "shape": [m, k, n], "library_ms": timed(lambda: torch.matmul(x, w_deq)),
            "plan": list(chosen), "plan_ms": times[chosen], "best": list(best),
            "best_ms": times[best], "plan_over_best": times[chosen] / times[best],
            "all_ms": {f"{bm}x{s}": t for (bm, s), t in sorted(times.items())}, "gpu": gpu,
        }), flush=True)
        del wd, ws, x, w_deq, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
