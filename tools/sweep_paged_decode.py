#!/usr/bin/env python3
"""Times the paged decode kernel (csrc/paged_decode.cu) under every split
size ``decode_plan`` could take, beside the plan it picks, at the phase-2
shapes of chip_smoke.py: llama3.2-3b's heads (8 x 3 x 128) at kv8 / kv4 /
bf16, ctx 1024 with and without a window of 256, and ctx 1 and 17; yi-9b's
heads (4 x 8 x 128) at kv8 / kv4; gemma3-1b's (1 x 4 x 256) with a window of
1024 at ctx 2048.  B = 8, page size 16.  Needs one CUDA card:

    python3 tools/sweep_paged_decode.py > sweep.jsonl

One JSON line per shape: median ms (CUDA events, L2 flushed before each
launch, as chip_smoke.py times) for MIN_SPLIT in 8, 16, 32, 64, 128, with the
splits each gives, and the max abs error against the plain version.  Rerun
it when the kernel or the card changes.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, B, ctx, Hkv, G, D, kv_bits, window)
CASES = [
    ("llama3.2-3b heads", 8, 1024, 8, 3, 128, 8, None),
    ("llama3.2-3b heads", 8, 1024, 8, 3, 128, 4, None),
    ("llama3.2-3b heads", 8, 1024, 8, 3, 128, 16, None),
    ("llama3.2-3b heads", 8, 1024, 8, 3, 128, 8, 256),
    ("llama3.2-3b heads", 8, 17, 8, 3, 128, 8, None),
    ("llama3.2-3b heads", 8, 1, 8, 3, 128, 8, None),
    ("yi-9b heads", 8, 1024, 4, 8, 128, 8, None),
    ("yi-9b heads", 8, 1024, 4, 8, 128, 4, None),
    ("gemma3-1b heads", 8, 2048, 1, 4, 256, 8, 1024),
]
MIN_SPLITS = [8, 16, 32, 64, 128]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_paged_decode: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode as pd

    gpu = smoke.gpu_line()
    timer = smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    chosen = pd.MIN_SPLIT
    ps, layer = 16, 1
    for label, b, ctx, hkv, g, d, kv_bits, window in CASES:
        w = -(-(max(ctx, 1024) + 1) // ps)
        n_pages = b * w + 4

        def payload(shape):
            x = torch.randn(*shape, generator=gen, device="cuda")
            return (x.to(torch.bfloat16), None) if kv_bits == 16 else ops.quantize_kv(x, kv_bits)

        kp, ks = payload((2, n_pages, ps, hkv, d))
        vp, vs = payload((2, n_pages, ps, hkv, d))
        nk, nks = payload((b, hkv, d))
        nv, nvs = payload((b, hkv, d))
        tables = torch.randperm(n_pages, generator=gen, device="cuda")[: b * w]
        tables = tables.reshape(b, w).to(torch.int32)
        lengths = torch.tensor([max(ctx - i % 3, 0) for i in range(b)], dtype=torch.int32,
                               device="cuda")
        q = torch.randn(b, hkv, g, d, generator=gen, device="cuda").to(torch.bfloat16)
        args = (kp, vp, ks, vs, tables, lengths, layer, nk, nv, nks, nvs)
        sm = 1 / math.sqrt(d)
        exp = ref.paged_mqa_decode_ref(q.reshape(b, hkv * g, d), *args, sm_scale=sm,
                                       kv_bits=kv_bits, window=window).float()
        rec = {"case": f"{label} {hkv}x{g}x{d} kv{kv_bits} B={b} ctx={ctx} window={window}",
               "gpu": gpu}
        try:
            for min_split in MIN_SPLITS:
                pd.MIN_SPLIT = min_split
                plan = pd.decode_plan(b, hkv, g, d, w, ps, window)

                def run():
                    return pd.paged_mqa_decode_cuda(q, *args, kv_bits=kv_bits, sm_scale=sm,
                                                    window=window)

                err = (run().reshape(b, hkv * g, d).float() - exp).abs().max().item()
                rec[f"min_split={min_split}"] = {
                    "ms": timer(run), "splits": plan["splits"], "per_split": plan["per_split"],
                    "max_abs_err": err, "chosen": min_split == chosen}
        finally:
            pd.MIN_SPLIT = chosen
        print(json.dumps(rec), flush=True)
        del kp, vp, ks, vs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
