#!/usr/bin/env python3
"""Times what the decode kernels' copies alone cost, beside the kernels.

Contiguous cache (``contiguous``): int8 K/V rows streamed into shared
memory in ``csrc/mqa_decode.cu``'s layout, grid and split
(tools/kv_copy_floor.cu: 16-byte cp.async as the kernel does, 16-byte loads
through registers, and one TMA bulk copy per row), beside the kernel itself
(scales and arithmetic included) and a plain clone of the K payload.

Paged pool (``paged``): the live rows of [L, P, ps, Hkv, Dk] int8 / int4
pages and their scales read through random page tables in
``csrc/paged_decode.cu``'s grid, split, ring and page lookups
(``decode_plan``), with no arithmetic, beside the paged kernel and SDPA on
the gathered, dequantized K/V (the phase-2 yardstick of chip_smoke.py), at
llama3.2-3b's serving shape and yi-9b's heads, B = 8, ctx 1024.

Needs one CUDA card:

    python3 tools/kv_copy_floor.py [contiguous] [paged] > floor.jsonl

One JSON line per shape: median ms (CUDA events, L2 flushed before each
launch, as chip_smoke.py times) and the read rate of the K/V payload.  The
source is built with nvcc into build/.
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
# (label, B, ctx, Hkv, G, D, ps): llama3.2-3b serving and yi-9b's heads
PAGED_SHAPES = [("llama3.2-3b serving", 8, 1024, 8, 3, 128, 16),
                ("yi-9b heads", 8, 1024, 4, 8, 128, 16)]


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
    lib.paged_copy_floor.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.paged_copy_floor.restype = ctypes.c_int
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
    which = sys.argv[1:] or ["contiguous", "paged"]
    if "paged" in which:
        paged(torch, lib, timed, gen, stream, gpu)
    for label, b, s, hkv, g, d in SHAPES if "contiguous" in which else []:
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


def paged(torch, lib, timed, gen, stream, gpu) -> None:
    """The paged pool's copy floor beside the paged kernel and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_decode import decode_plan, paged_mqa_decode_cuda

    n_layers, layer = 2, 1
    for label, b, ctx, hkv, g, d, ps in PAGED_SHAPES:
        for kv_bits in (8, 4):
            w = -(-(ctx + 1) // ps)
            n_pages = b * w + 4
            shape = (n_layers, n_pages, ps, hkv, d)
            kp, ks = ops.quantize_kv(torch.randn(*shape, generator=gen, device="cuda"), kv_bits)
            vp, vs = ops.quantize_kv(torch.randn(*shape, generator=gen, device="cuda"), kv_bits)
            nk, nks = ops.quantize_kv(torch.randn(b, hkv, d, generator=gen, device="cuda"),
                                      kv_bits)
            nv, nvs = ops.quantize_kv(torch.randn(b, hkv, d, generator=gen, device="cuda"),
                                      kv_bits)
            tables = torch.randperm(n_pages, generator=gen, device="cuda")[: b * w]
            tables = tables.reshape(b, w).to(torch.int32)
            lens = [ctx - (i % 3) for i in range(b)]
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = torch.randn(b, hkv, g, d, generator=gen, device="cuda").to(torch.bfloat16)
            plan = decode_plan(b, hkv, g, d, w, ps)
            sink = torch.empty(b * plan["grid"][1] * 128, device="cuda")
            dk = kp.shape[-1]
            payload = 2 * sum(lens) * hkv * (dk + 4)  # K and V rows and scales

            def copy():
                err = lib.paged_copy_floor(
                    kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                    tables.data_ptr(), lengths.data_ptr(), sink.data_ptr(), b, layer,
                    n_pages, ps, hkv, d, w, kv_bits, 0, plan["groups"], plan["splits"],
                    plan["per_split"], stream)
                if err:
                    raise RuntimeError(f"paged_copy_floor: CUDA error {err}")

            args = (kp, vp, ks, vs, tables, lengths, layer, nk, nv, nks, nvs)
            sm = 1 / math.sqrt(d)

            def gathered(pool, scale, new, new_scale):
                old = ref._dequant(ref.gather_pages(pool, tables)[layer],
                                   ref.gather_pages(scale, tables)[layer], kv_bits)
                full = torch.cat([old, ref._dequant(new[:, None], new_scale[:, None], kv_bits)],
                                 dim=1)
                return full.to(torch.bfloat16).transpose(1, 2).repeat_interleave(g, dim=1)

            kg, vg = gathered(kp, ks, nk, nks), gathered(vp, vs, nv, nvs)
            pos = torch.arange(kg.shape[2], device="cuda")
            mask = ((pos[None] < lengths[:, None]) | (pos[None] == kg.shape[2] - 1))[:, None, None]
            q4 = q.reshape(b, hkv * g, 1, d)
            rec = {"case": f"{label} kv{kv_bits} B={b} ctx={ctx} Hkv={hkv} G={g} D={d} ps={ps}",
                   "plan": plan, "payload_mb": payload / 1e6, "gpu": gpu}
            for name, fn in (("paged copies", copy),
                             ("paged_decode", lambda: paged_mqa_decode_cuda(
                                 q, *args, kv_bits=kv_bits, sm_scale=sm)),
                             ("sdpa", lambda: F.scaled_dot_product_attention(
                                 q4, kg, vg, attn_mask=mask))):
                ms = timed(fn)
                rec[name] = {"ms": ms, "payload_tb_per_s": payload / ms / 1e9}
            rec["bound_ms"] = payload / 3.35e12 * 1e3
            print(json.dumps(rec), flush=True)
            del kp, vp, ks, vs, kg, vg
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
