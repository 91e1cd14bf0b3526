#!/usr/bin/env python3
"""Times what the contiguous-cache decode kernel's copies alone cost: int8
K/V rows streamed into shared memory in the kernel's layout, grid and split
(tools/kv_copy_floor.cu: 16-byte cp.async as the kernel does, 16-byte loads
through registers, and one TMA bulk copy per row), beside the kernel itself
(csrc/mqa_decode.cu, scales and arithmetic included) and a plain clone of the
K payload.  Needs one CUDA card:

    python3 tools/kv_copy_floor.py > floor.jsonl

One JSON line per shape of chip_smoke.py's phase 2 (kv8): median ms (CUDA
events, L2 flushed before each launch, as chip_smoke.py times) and the read
rate of the K/V payload.  The source is built with nvcc into build/.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, B, S, Hkv, G, D): zamba2-7b serving and 32k context, llama3.2-3b GQA
SHAPES = [("zamba2 serving", 8, 552, 32, 1, 112), ("zamba2 long context", 1, 32768, 32, 1, 112),
          ("llama3.2-3b GQA", 8, 1024, 8, 3, 128)]
ENGINES = ["cp.async 16 B", "registers 16 B", "cp.async.bulk"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kv_copy_floor: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.mqa_decode import decode_plan, mqa_decode_cuda

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    so = _build.BUILD_DIR / "libkv_copy_floor.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                    "-o", str(so), str(ROOT / "tools" / "kv_copy_floor.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.kv_copy_floor.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.kv_copy_floor.restype = ctypes.c_int
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
    for label, b, s, hkv, g, d in SHAPES:
        kd, ks = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen, device="cuda"), 8)
        vd, vs = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen, device="cuda"), 8)
        q = torch.randn(b, hkv, g, d, generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        plan = decode_plan(b, hkv, g, s)
        sink = torch.empty(b * -(-hkv // 4) * plan["splits"] * 128, device="cuda")
        payload = 2 * kd.numel()
        rec = {"case": f"{label} kv8 B={b} S={s} Hkv={hkv} G={g} D={d}", "plan": plan,
               "payload_mb": payload / 1e6, "gpu": gpu}
        for engine, name in enumerate(ENGINES):
            def copy(engine=engine):
                err = lib.kv_copy_floor(engine, kd.data_ptr(), vd.data_ptr(), sink.data_ptr(), b,
                                        s, hkv, d, plan["splits"], plan["per_split"], stream)
                if err:
                    raise RuntimeError(f"kv_copy_floor: CUDA error {err}")
            ms = timed(copy)
            rec[name] = {"ms": ms, "payload_tb_per_s": payload / ms / 1e9}
        ms = timed(lambda: mqa_decode_cuda(q, kd, vd, ks, vs, lens, kv_bits=8,
                                           sm_scale=1 / math.sqrt(d)))
        rec["mqa_decode"] = {"ms": ms, "payload_tb_per_s": payload / ms / 1e9}
        ms = timed(lambda: kd.clone())
        rec["clone K"] = {"ms": ms, "read_write_tb_per_s": 2 * kd.numel() / ms / 1e9}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
