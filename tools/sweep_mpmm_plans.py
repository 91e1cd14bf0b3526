#!/usr/bin/env python3
"""Times the matmul kernels under every launch plan they take at a list of
shapes, beside the plan ``src/repro_torch/kernels/mpmm.py`` picks and a
PyTorch call that computes the same product.  Needs one CUDA card:

    python3 tools/sweep_mpmm_plans.py [cf] [decode] [int] [x32] > sweep.jsonl

(no section named: all four).  One JSON line per shape, each with every
plan's median time in ms (CUDA events, L2 flushed before each launch, as
chip_smoke.py times), the chosen plan's time and the fastest:

- ``cf``: the CF dequant matmul's tensor-core kernel at prefill M, every
  (block_m, splits), beside ``launch_plan`` and the bf16 matmul on the
  pre-dequantized weights; w8.
- ``decode``: the CF dequant matmul at M 1, 2, 4, 8 and the serving path's
  (K, N), w4 and w8: the 8-row tile at every K split and the 64-row tile
  (the FF order's route) at its splits, beside ``launch_plan``; the chosen
  plan and the library call also with the L2 left warm (``*_warm_ms``).
- ``int``: the int-mode matmul at ResNet18's int shapes, int8 and int16 x
  w8: the CF order at every K split the entry point takes and the FF order,
  beside ``int_launch_plan`` and, for int8 x, ``torch._int_mm``.
- ``x32``: the CF dequant matmul on float32 x (the two-term TF32 kernel,
  whose block rows follow M) at every K split, beside ``x32_launch_plan``
  and ``torch.mm`` in full f32 on the pre-dequantized weights.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

CF_SHAPES = [  # (M, K, N): llama3.2-3b projections at M 128 / 256, ResNet18's CF
    # layers at batch 8, zamba2-7b's in_proj at its prefill M
    (128, 3072, 3072), (128, 3072, 1024), (128, 3072, 8192), (128, 8192, 3072),
    (256, 3072, 3072), (256, 3072, 1024), (256, 8192, 3072), (256, 3072, 8192),
    (392, 256, 512), (1568, 128, 256), (6272, 64, 128), (4096, 3584, 14576),
]
# (K, N) of the serving path's projections (chip_smoke.py's MPMM_SHAPES)
DECODE_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]
DECODE_SPLITS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)
# (label, M, K, N): chip_smoke.py's int cases, and ResNet18 convs at batch 1
# and 2 (the int checks' batches) that span its K, N and M
INT_SHAPES = [("layer3.1.conv1 b2", 392, 2304, 256), ("layer1.0.conv2 b1", 3136, 576, 64),
              ("conv1 b1", 12544, 147, 64), ("short last split", 392, 2240, 256),
              ("conv1 b2", 25088, 147, 64), ("layer2.0.conv2 b1", 784, 1152, 128),
              ("layer2.0.down b2", 1568, 64, 128), ("layer4.1.conv2 b2", 98, 4608, 512),
              ("layer4.1.conv2 b1", 49, 4608, 512), ("layer1.0.conv2 b2", 6272, 576, 64)]
# (M, K, N, w_bits) of the f32-activation CF order: ResNet18's CF layers at
# batch 8, chip_smoke.py's rows 3a / 3b, the quickstart's section 4, and
# llama3.2-3b projections at M 1 and 128
X32_SHAPES = [(6272, 64, 128, 8), (1568, 128, 256, 8), (392, 256, 512, 8),
              (8, 3072, 8192, 4), (256, 3072, 3072, 8), (64, 512, 256, 4),
              (1, 3072, 3072, 8), (128, 3072, 3072, 8), (128, 3072, 8192, 8),
              (128, 8192, 3072, 8)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_mpmm_plans: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build, mpmm, ops
    from repro_torch.quant.pack import unpack_int4

    sections = set(sys.argv[1:]) or {"cf", "decode", "int", "x32"}
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    lib = _build.lib()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, iters=10, cold=True):
        fn()
        times = []
        for _ in range(iters):
            if cold:
                flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    def report(shape, chosen, times, library_ms, **extra):
        best = min(times, key=times.get)
        print(json.dumps({
            "shape": shape, "library_ms": library_ms, "plan": list(chosen),
            "plan_ms": times[chosen], "best": list(best), "best_ms": times[best],
            "plan_over_best": times[chosen] / times[best],
            "all_ms": {"x".join(map(str, key)): t for key, t in sorted(times.items())},
            **extra, "gpu": gpu,
        }), flush=True)

    def dequant_times(x, wd, ws, w_bits, cands, warm=()):
        """{(block_m, splits): ms} for each (block_m, splits) -> K rows per split;
        for the plans in ``warm``, also their time with the L2 not flushed
        (under the key (block_m, splits, "warm"))."""
        m, k = x.shape
        n = wd.shape[-1]
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        times = {}
        for (bm, splits), per in cands.items():
            part = torch.empty(splits, m, n, device="cuda") if splits > 1 else out

            def run():
                err = lib.mpmm_dequant_bf16(
                    x.data_ptr(), wd.data_ptr(), ws.data_ptr(), out.data_ptr(),
                    part.data_ptr(), m, n, k, w_bits, splits, per, bm, stream)
                if err:
                    raise RuntimeError(f"mpmm_dequant_bf16: CUDA error {err}")
            times[(bm, splits)] = timed(run)
            if (bm, splits) in warm:
                times[(bm, splits, "warm")] = timed(run, cold=False)
        return times

    def tc_cands(k, block_ms, wants):
        cands = {}
        for bm in block_ms:
            step = mpmm.DECODE_BK if bm == mpmm.DECODE_M else mpmm.TC_BK
            steps = -(-k // step)
            for want in wants:
                if want <= steps:
                    per = -(-steps // want) * step
                    cands.setdefault((bm, -(-k // per)), per)
        return cands

    gen = torch.Generator(device="cuda").manual_seed(0)
    if "cf" in sections:
        for m, k, n in CF_SHAPES:
            wd, ws = ops.pack_weights(torch.randn(k, n, generator=gen, device="cuda")
                                      / math.sqrt(k), 8)
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            w_deq = (wd.float() * ws).to(torch.bfloat16)
            plan = mpmm.launch_plan(m, n, k)
            chosen = (plan["block_m"], plan["splits"])
            cands = {**tc_cands(k, mpmm.TC_BLOCK_M, (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24)),
                     chosen: plan["k_per_split"]}
            report([m, k, n], chosen, dequant_times(x, wd, ws, 8, cands),
                   timed(lambda: torch.matmul(x, w_deq)), section="cf")
            del wd, ws, x, w_deq
            torch.cuda.empty_cache()

    if "decode" in sections:
        for w_bits in (4, 8):
            for k, n in DECODE_SHAPES:
                wd, ws = ops.pack_weights(torch.randn(k, n, generator=gen, device="cuda")
                                          / math.sqrt(k), w_bits)
                w_deq = ((unpack_int4(wd, 0) if w_bits == 4 else wd).float() * ws).to(
                    torch.bfloat16)
                for m in (1, 2, 4, 8):
                    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                    plan = mpmm.launch_plan(m, n, k, w_bits=w_bits)
                    chosen = (plan["block_m"], plan["splits"])
                    cands = {**tc_cands(k, (mpmm.DECODE_M, 64), DECODE_SPLITS),
                             chosen: plan["k_per_split"]}
                    times = dequant_times(x, wd, ws, w_bits, cands, warm=(chosen,))
                    warm_ms = times.pop((*chosen, "warm"))
                    report([m, k, n], chosen, times, timed(lambda: torch.matmul(x, w_deq)),
                           section="decode", w_bits=w_bits, plan_warm_ms=warm_ms,
                           library_warm_ms=timed(lambda: torch.matmul(x, w_deq), cold=False))
                del wd, ws, w_deq
                torch.cuda.empty_cache()

    if "int" in sections:
        for label, m, k, n in INT_SHAPES:
            for x_bits in (8, 16):
                dt = torch.int8 if x_bits == 8 else torch.int16
                lim = 2 ** (x_bits - 1)
                x = torch.randint(-lim, lim, (m, k), generator=gen, device="cuda", dtype=dt)
                wd = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                                   dtype=torch.int8)
                out = torch.empty(m, n, dtype=torch.int32, device="cuda")
                exp = None
                steps = -(-k // mpmm.TC_BK)
                ranges = {("cf", 1): k, ("ff", -(-k // 512)): 512}
                for per in range(2, steps):
                    if k >= 512:
                        ranges.setdefault(("cf", -(-steps // per)), per * mpmm.TC_BK)
                times = {}
                for (order, stages), stage_k in ranges.items():
                    part = torch.empty(stages, m, n, dtype=torch.int32, device="cuda")

                    def run():
                        err = lib.mpmm_int_i32(x.data_ptr(), wd.data_ptr(), out.data_ptr(),
                                               part.data_ptr(), m, n, k, x_bits, 8, stage_k,
                                               stages, stream)
                        if err:
                            raise RuntimeError(f"mpmm_int_i32: CUDA error {err}")
                    times[(order, stages)] = timed(run)
                    if exp is None:
                        exp = out.clone()
                    if not torch.equal(out, exp):
                        raise RuntimeError(f"int {label} {order} x{stages}: other bits")
                # torch._int_mm: int8 x int8 with M > 16 and K, N multiples of 8
                library_ms = (timed(lambda: torch._int_mm(x, wd))
                              if x_bits == 8 and m > 16 and k % 8 == 0 and n % 8 == 0 else None)
                for order in ("cf", "ff"):
                    plan = mpmm.int_launch_plan(m, n, k, order)
                    chosen = (order, plan["stages"])
                    report([m, k, n], chosen,
                           {key: t for key, t in times.items() if key[0] == order},
                           library_ms, section="int", label=label, x_bits=x_bits)
                del x, wd, out, exp
                torch.cuda.empty_cache()

    if "x32" in sections:
        for m, k, n, w_bits in X32_SHAPES:
            wd, ws = ops.pack_weights(torch.randn(k, n, generator=gen, device="cuda")
                                      / math.sqrt(k), w_bits)
            x = torch.randn(m, k, generator=gen, device="cuda")
            w_deq = (unpack_int4(wd, 0) if w_bits == 4 else wd).float() * ws
            plan = mpmm.x32_launch_plan(m, n, k, w_bits=w_bits)
            bm = plan["block_m"]
            step = mpmm.DECODE_BK if bm == mpmm.DECODE_M else mpmm.X32_BK
            steps = -(-k // step)
            cands = {plan["splits"]: plan["k_per_split"]}
            for want in DECODE_SPLITS:
                if want <= steps:
                    per = -(-steps // want) * step
                    cands.setdefault(-(-k // per), per)
            out = torch.empty(m, n, device="cuda")
            times = {}
            for splits, per in cands.items():
                part = torch.empty(splits, m, n, device="cuda") if splits > 1 else out

                def run():
                    err = lib.mpmm_dequant_x32(
                        x.data_ptr(), wd.data_ptr(), ws.data_ptr(), out.data_ptr(),
                        part.data_ptr(), m, n, k, w_bits, splits, per, stream)
                    if err:
                        raise RuntimeError(f"mpmm_dequant_x32: CUDA error {err}")
                times[(bm, splits)] = timed(run)
            report([m, k, n], (bm, plan["splits"]), times, timed(lambda: torch.mm(x, w_deq)),
                   section="x32", w_bits=w_bits)
            del wd, ws, x, w_deq, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
