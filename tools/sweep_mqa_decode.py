#!/usr/bin/env python3
"""Times the contiguous-cache decode kernel (csrc/mqa_decode.cu) under
several position splits, beside the one ``decode_plan`` picks, at
paligemma-3b's heads (1 kv head x 8 queries of D 256, kv8: the wide
instantiation, one-warp blocks): one rank's 8 rows of decode_32k (S 32768),
4 rows of it, and 8 rows of 2048.  Needs one CUDA card:

    python3 tools/sweep_mqa_decode.py > sweep.jsonl

One JSON line per (shape, splits): median ms (CUDA events, L2 flushed before
each launch, as chip_smoke.py times) and the max abs error against the plain
version, within chip_smoke.py's ATTN_TOL.  Rerun it when the kernel or the
card changes.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [(8, 32768, 1, 8, 256), (4, 32768, 1, 8, 256), (8, 2048, 1, 8, 256)]  # B, S, Hkv, G, D
SPLITS = [1, 8, 16, 33, 66, 128, 256, 512]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_mqa_decode: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.mqa_decode import decode_plan

    gpu = cs.gpu_line()
    _build.build()
    lib = _build.lib()
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, s, hkv, g, d in CASES:
        kd, ks = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen, device="cuda"), 8)
        vd, vs = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen, device="cuda"), 8)
        q = torch.randn(b, hkv, g, d, generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.tensor([s - (i % 3) for i in range(b)], dtype=torch.int32, device="cuda")
        sm = 1 / math.sqrt(d)
        exp = ref.mqa_decode_ref(q.reshape(b, hkv * g, d), kd, vd, ks, vs, lens,
                                 sm_scale=sm).reshape(b, hkv, g, d)
        plan = decode_plan(b, hkv, g, s, d)
        for want in sorted({*SPLITS, plan["splits"]}):
            per = -(-(-(-s // want)) // 8) * 8  # whole 8-token tiles, as decode_plan
            n = -(-s // per)
            out = torch.empty_like(q)
            part = torch.empty((b, hkv, n, g * (d + 2)), dtype=torch.float32, device="cuda")

            def call():
                err = lib.mqa_decode(q.data_ptr(), kd.data_ptr(), vd.data_ptr(), ks.data_ptr(),
                                     vs.data_ptr(), lens.data_ptr(), out.data_ptr(),
                                     (part if n > 1 else out).data_ptr(), b, s, hkv, g, d, 8,
                                     0, n, per, sm, torch.cuda.current_stream().cuda_stream)
                _build.check(err, "mqa_decode")

            call()
            torch.cuda.synchronize()
            cs.emit({"tool": "sweep_mqa_decode", "b": b, "s": s, "heads": [hkv, g, d],
                     "splits": n, "per_split": per, "plan": n == plan["splits"],
                     "ms": timer(call), "max_abs_err": cs.max_err(torch, out, exp, cs.ATTN_TOL),
                     "gpu": gpu})
    return 0


if __name__ == "__main__":
    sys.exit(main())
