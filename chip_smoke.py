#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and checks it.

    python3 chip_smoke.py

Phases, each printing one JSON line that names the card:

1. build    -- nvcc builds the kernels under src/repro_torch/kernels/csrc.
2. kernels  -- each hand-written kernel against its plain PyTorch version on
               the same inputs, in bf16 at llama3.2-3b's serving shapes (the
               CF dequant matmul at decode M 1-8 and at the prefill M of 128
               and 256, and at zamba2-7b's in_proj / out_proj at M = 4096;
               two runs of it at every M and of paged prefill must give the
               same bits) and at
               ResNet18's conv shapes (the FF-order dequant matmul), and
               bit-exactly against the CPU's int32 matmul (the int-mode
               matmul, also under a CF K split with a short last split); the
               CF dequant matmul also at ResNet18's three CF layers (the 1x1
               stride-2 downsample convs): max abs error against the stated
               tolerance, the kernel's time, the plain version's, a PyTorch
               library call's as a yardstick, and the least time the card
               could take (bound_ms).
3. step     -- a 2-layer cut of llama3.2-3b at full width (d_model 3072,
               vocab 128256): one chunked-prefill step and one decode step on
               the card (kernels) and on the CPU (plain versions); the logits
               must agree and pick the same token on every row.
4. cnn      -- the paper's CNN path: full ResNet18 (20 convs, 224x224x3 bf16
               input, batch 8, w8, the mixed FF/CF strategy) through
               models.cnn.run_network: per-layer decisions (17 FF / 3 CF),
               images/s, peak memory, the FF kernel's device time and
               launches in one profiled run; card vs CPU at batch 2 (bf16
               card vs bf16 and float32 CPU); a w4 run over layers 2-20; three layers
               through ops.mpconv(mode="int") on int16 activations, bit-exact
               against the CPU.
5. engine   -- the full 28-layer llama3.2-3b with seeded random weights
               served by ServeEngine.generate(): 8 greedy requests with
               512-token prompts (256 shared), 32 new tokens each, weight/KV
               precision cycling over (4,8) (8,4) (8,8) (16,16); run twice,
               the streams must be identical; then one chunk-prefill group
               call (4 x 128 tokens, w8/kv8) under the profiler.
6. waves    -- the full 81-layer zamba2-7b (hybrid: Mamba2 + shared
               attention) with seeded random weights served by the
               static-wave train.server.Server: 8 greedy requests of 512
               random tokens, 32 new tokens each, batch 8, w8/kv8; run
               twice, the streams must be identical; two decode steps
               profiled (the device time and launches of mqa_decode and of
               the CF matmul's decode-M tile among them);
               then full mamba2-130m (ssm) served the same way.
7. kernels line -- each kernel's launches on its path (all > 0): the serving
               kernels in phase 5's first run, the FF and int matmuls in
               phase 4, contiguous-cache decode in phase 6's first zamba2
               run; the counts are set to 0 just before each path runs.

Phase 2 also holds contiguous-cache decode (mqa_decode) against its plain
version at zamba2-7b's serving shape (kv8 and kv4), a 32k context and
llama3.2-3b's GQA shape; phase 3 also runs zamba2-7b cut to 7 layers at full
width (prefill and two decode steps) on the card and on the CPU.

The last line is {"ok": true, "device": {...}}; any failed check raises and
the script exits nonzero without it.  It exits nonzero too when no CUDA card
is present or when it is run outside a checkout of the repository.
Times come from CUDA events with the L2 cache flushed before every launch
(the serving path finds weights and pages cold); bound_ms is the larger of
the bytes the call must move over 3.35 TB/s and its operations over 989
TFLOP/s (H100 SXM bf16 dense peak, at the full 700 W power limit), or, for
the int-mode matmul, its int8 tensor-core operations (one pass per pair of
radix-256 digit planes) over 1979 TOP/s.  The int-mode plain version runs on
the CPU (CUDA has no int32 matmul), so its plain_ms is a host-clock time on
the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
MPMM_TOL = dict(atol=2e-2, rtol=1e-2)  # bf16 output: one rounding step each way
ATTN_TOL = dict(atol=1e-2, rtol=1e-2)
MPMM_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]
PRECISIONS = [(4, 8), (8, 4), (8, 8), (16, 16)]
# zamba2-7b's in_proj (d_model -> 2 * d_inner + 2 * state + heads) and
# out_proj (d_inner -> d_model) as (K, N), run at its prefill M (8 x 512)
ZAMBA_PREFILL_SHAPES = [(3584, 14576), (7168, 3584)]
# the CF kernel's prefill-M case of the kernels line: (w_bits, M, K, N)
PREFILL_MPMM_CASE = (8, 256, 3072, 3072)

TPU_KERNELS = {
    "mpmm_dequant": ("src/repro_torch/kernels/csrc/mpmm.cu",
                     "src/repro/kernels/mpmm.py:174 (mpmm_pallas, CF dequant)"),
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:153 (paged_mqa_decode_pallas)"),
    "paged_prefill": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill.py:157 (paged_mqa_prefill_pallas)"),
    "mpmm_ff_dequant": ("src/repro_torch/kernels/csrc/mpmm.cu",
                        "src/repro/kernels/mpmm.py:174 (mpmm_pallas, FF dequant: "
                        "_mpmm_ff_kernel :148, pallas_call :244)"),
    "mpmm_int": ("src/repro_torch/kernels/csrc/mpmm_int.cu",
                 "src/repro/kernels/mpmm.py:174 (mpmm_pallas, int mode: _digit_planes :64, "
                 "_plane_dot :79)"),
    "mqa_decode": ("src/repro_torch/kernels/csrc/mqa_decode.cu",
                   "src/repro/kernels/mqa_decode.py:101 (mqa_decode_pallas: _decode_kernel "
                   ":40, pallas_call :133)"),
}
# the path each kernel's launches are read from in the kernels line
KERNEL_PATH = {"mpmm_dequant": "serve", "paged_decode": "serve", "paged_prefill": "serve",
               "mpmm_ff_dequant": "cnn", "mpmm_int": "cnn", "mqa_decode": "waves"}
# phase 2 mqa_decode cases: (label, B, S, Hkv, G, D, lengths, kv_bits); zamba2-7b
# serving (S = 512 prompt + 32 new + 8), a long context, llama3.2-3b's GQA
MQA_CASES = [
    ("zamba2 serving", 8, 552, 32, 1, 112, list(range(545, 553)), 8),
    ("zamba2 serving", 8, 552, 32, 1, 112, list(range(545, 553)), 4),
    ("zamba2 long context", 1, 32768, 32, 1, 112, [32768], 8),
    ("llama3.2-3b GQA", 8, 1024, 8, 3, 128, [1024 - (i % 3) for i in range(8)], 8),
]
WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW = 8, 512, 32
# the ResNet18 convs phase 2 times the FF matmul at (batch 8): M = 8*Ho*Wo
FF_LAYERS = ["conv1", "layer1.0.conv2", "layer3.1.conv1", "layer4.1.conv1"]
CF_LAYERS = ["layer2.0.down", "layer3.0.down", "layer4.0.down"]  # the CF layers at w8
INT_GRID = [(16, 16), (8, 8), (4, 8), (8, 16), (16, 8)]  # (w_bits, x_bits)
INT_LAYERS = ["conv1", "layer2.0.down", "layer4.1.conv2"]  # phase 4 int mode: FF, CF, FF


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median per-launch device time in ms from CUDA events, L2 flushed
    before each launch.  A device-side sleep queued ahead of the start event
    keeps the card busy while the host enqueues the call, so the events
    time the device work and not the Python wrapper's enqueue latency."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(2_000_000)  # about 1 ms at the H100's clock
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def max_err(torch, got, exp, tol) -> float:
    got, exp = got.float(), exp.float()
    err = (got - exp).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    bad = err > tol["atol"] + tol["rtol"] * exp.abs()
    check(not bool(bad.any()), "kernel disagrees with its plain version: max abs err "
          f"{err.max().item():.4g} (tolerance atol={tol['atol']} rtol={tol['rtol']})")
    return err.max().item()


# --------------------------------------------------------------- phase 2
def kernel_cases(torch, timer, gpu) -> dict:
    """Every kernel against its plain version; returns per-kernel summaries."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mpmm import launch_plan, mpmm_cuda
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import launch_grid, paged_mqa_prefill_cuda
    from repro_torch.quant.pack import unpack_int4

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {name: {"max_abs_err": 0.0} for name in TPU_KERNELS}

    def note(name, rec, representative):
        note_case(summary, gpu, name, rec, representative)

    # ---- mpmm: w4/w8, every (K, N) of the serving path; M covers each
    # decode batch bucket and two odd row counts (the 8-row tile takes any
    # M <= 8), the engine's prefill chunk (128) and a larger prefill M;
    # then zamba2-7b's in_proj / out_proj at its prefill M (8 x 512
    # tokens), w8.  Every case's K split is summed in a fixed order, so two
    # runs must give the same bits
    def mpmm_case(x, wd, ws, w_bits, w_deq):
        m, k = x.shape
        n = wd.shape[-1]
        got = mpmm_cuda(x, wd, ws, w_bits=w_bits)
        exp = ref.mpmm_ref(x, wd, ws, w_bits=w_bits)
        err = max_err(torch, got, exp, MPMM_TOL)
        del exp
        check(torch.equal(got, mpmm_cuda(x, wd, ws, w_bits=w_bits)),
              f"mpmm w{w_bits} M={m} K={k} N={n}: two runs gave other bits")
        nbytes = m * k * 2 + wd.numel() + n * 4 + m * n * 2
        flops = 2.0 * m * n * k
        b_ms, b_by = bound(nbytes, flops)
        plan = launch_plan(m, n, k, w_bits=w_bits)
        rec = {
            "case": f"w{w_bits} M={m} K={k} N={n}", "max_abs_err": err, "tol": MPMM_TOL,
            "kernel_plan": {key: plan[key] for key in ("block_m", "splits", "grid")},
            "ms": timer(lambda: mpmm_cuda(x, wd, ws, w_bits=w_bits)),
            "plain_ms": timer(lambda: ref.mpmm_ref(x, wd, ws, w_bits=w_bits), iters=3),
            "library_ms": timer(lambda: torch.matmul(x, w_deq)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["library_tflops"] = flops / rec["library_ms"] / 1e9
        note("mpmm_dequant", rec, (w_bits, m, k, n) == (4, 8, 3072, 8192))
        if (w_bits, m, k, n) == PREFILL_MPMM_CASE:
            summary["mpmm_dequant"]["prefill"] = {key: rec[key] for key in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}

    def deq(wd, ws, w_bits):
        return ((unpack_int4(wd, 0) if w_bits == 4 else wd).float() * ws).to(torch.bfloat16)

    for w_bits in (4, 8):
        for k, n in MPMM_SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            wd, ws = ops.pack_weights(w, w_bits)
            w_deq = deq(wd, ws, w_bits)
            del w
            for m in (1, 2, 3, 4, 5, 8, 128, 256):
                x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                mpmm_case(x, wd, ws, w_bits, w_deq)
            del wd, ws, w_deq
    torch.cuda.empty_cache()
    for k, n in ZAMBA_PREFILL_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        wd, ws = ops.pack_weights(w, 8)
        w_deq = deq(wd, ws, 8)
        del w
        x = torch.randn(WAVE_REQUESTS * WAVE_PROMPT, k, generator=gen,
                        device="cuda").to(torch.bfloat16)
        mpmm_case(x, wd, ws, 8, w_deq)
        del x, wd, ws, w_deq
        torch.cuda.empty_cache()

    # ---- paged attention inputs at llama3.2-3b's widths
    hkv, g, d, ps, n_layers, layer = 8, 3, 128, 16, 2, 1
    h = hkv * g

    def payload(shape, kv_bits):
        """Random K or V in the pool's format: (payload, per-token scales)."""
        x = torch.randn(*shape, generator=gen, device="cuda")
        if kv_bits == 16:
            return x.to(torch.bfloat16), None
        return ops.quantize_kv(x, kv_bits)

    def kv_bytes(tokens, kv_bits):
        per_tok = hkv * (d // 2 if kv_bits == 4 else d) * (2 if kv_bits == 16 else 1)
        return tokens * 2 * (per_tok + (hkv * 4 if kv_bits < 16 else 0))

    def gathered(pool, scale, tables, kv_bits, new, new_scale):
        """[B, H, S, D] bf16 K or V for SDPA: the table's pages dequantized,
        then the new token(s) [B, T, Hkv, Dk], KV heads repeated to H."""
        sc = None if scale is None else ref.gather_pages(scale, tables)[layer]
        old = ref._dequant(ref.gather_pages(pool, tables)[layer], sc, kv_bits)
        full = torch.cat([old, ref._dequant(new, new_scale, kv_bits)], dim=1)
        return full.to(torch.bfloat16).transpose(1, 2).repeat_interleave(g, dim=1).contiguous()

    def touched(n, lo):
        """Table slots a row reads for live positions [lo, n)."""
        return -(-n // ps) - lo // ps if n > lo else 0

    # ---- paged decode: B = 8, ctx in {0, 1, 17, 1024}, with and without a window
    b = 8
    for kv_bits in (4, 8, 16):
        w = -(-1025 // ps)
        n_pages = b * w + 4
        kp, ks = payload((n_layers, n_pages, ps, hkv, d), kv_bits)
        vp, vs = payload((n_layers, n_pages, ps, hkv, d), kv_bits)
        tables = torch.randperm(n_pages, generator=gen, device="cuda")[: b * w]
        tables = tables.reshape(b, w).to(torch.int32)
        nk, nks = payload((b, hkv, d), kv_bits)
        nv, nvs = payload((b, hkv, d), kv_bits)
        q = torch.randn(b, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        qg = q.reshape(b, hkv, g, d)
        for ctx in (0, 1, 17, 1024):
            lengths = torch.tensor([max(ctx - (i % 3), 0) for i in range(b)],
                                   dtype=torch.int32, device="cuda")
            for window in (None, 256):
                args = (kp, vp, ks, vs, tables, lengths, layer, nk, nv, nks, nvs)
                sm = 1 / math.sqrt(d)
                got = paged_mqa_decode_cuda(qg, *args, kv_bits=kv_bits, sm_scale=sm,
                                            window=window).reshape(b, h, d)
                exp = ref.paged_mqa_decode_ref(q, *args, sm_scale=sm, kv_bits=kv_bits,
                                               window=window)
                err = max_err(torch, got, exp, ATTN_TOL)
                lens = lengths.tolist()
                los = [max(n + 1 - window, 0) if window else 0 for n in lens]
                live = [n - lo if n > lo else 0 for n, lo in zip(lens, los)]
                slots = sum(touched(n, lo) for n, lo in zip(lens, los))
                nbytes = 2 * q.numel() * 2 + kv_bytes(sum(live) + b, kv_bits) + 4 * (slots + b)
                b_ms, b_by = bound(nbytes, 4.0 * h * d * sum(n + 1 for n in live))
                # library yardstick: SDPA over gathered, dequantized K/V + new token
                one = lambda t: None if t is None else t[:, None]  # noqa: E731
                kg = gathered(kp, ks, tables, kv_bits, one(nk), one(nks))
                vg = gathered(vp, vs, tables, kv_bits, one(nv), one(nvs))
                pos = torch.arange(kg.shape[2], device="cuda")
                mask = (pos[None] < lengths[:, None]) | (pos[None] == kg.shape[2] - 1)
                if window:
                    mask &= pos[None] >= (lengths[:, None] + 1 - window)
                mask = mask[:, None, None, :]
                q4 = q[:, :, None, :]
                rec = {
                    "case": f"kv{kv_bits} B={b} ctx={ctx} window={window}",
                    "max_abs_err": err, "tol": ATTN_TOL,
                    "ms": timer(lambda: paged_mqa_decode_cuda(
                        qg, *args, kv_bits=kv_bits, sm_scale=sm, window=window)),
                    "plain_ms": timer(lambda: ref.paged_mqa_decode_ref(
                        q, *args, sm_scale=sm, kv_bits=kv_bits, window=window), iters=3),
                    "library_ms": timer(lambda: F.scaled_dot_product_attention(
                        q4, kg, vg, attn_mask=mask)),
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                note("paged_decode", rec, (kv_bits, ctx, window) == (8, 1024, None))
        del kp, vp, ks, vs
    torch.cuda.empty_cache()

    # ---- paged prefill: C in {1, 32, 128}, ragged q_lens, ctx > 0
    b = 4
    ctx_list = [256, 200, 384, 128]
    for kv_bits in (4, 8, 16):
        w = -(-(max(ctx_list) + 128) // ps)
        n_pages = b * w + 4
        kp, ks = payload((n_layers, n_pages, ps, hkv, d), kv_bits)
        vp, vs = payload((n_layers, n_pages, ps, hkv, d), kv_bits)
        tables = torch.randperm(n_pages, generator=gen, device="cuda")[: b * w]
        tables = tables.reshape(b, w).to(torch.int32)
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
        for c in (1, 32, 128):
            q_lens = torch.tensor([c, max(c - 1, 1), max(c // 2, 1), 1],
                                  dtype=torch.int32, device="cuda")
            q = torch.randn(b, c, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            ck, cks = payload((b, c, hkv, d), kv_bits)
            cv, cvs = payload((b, c, hkv, d), kv_bits)
            qg = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4).contiguous()

            def t(x):
                return None if x is None else x.transpose(1, 2).contiguous()

            kargs = (kp, vp, ks, vs, tables, ctx, q_lens, layer, t(ck), t(cv), t(cks), t(cvs))
            pargs = (kp, vp, ks, vs, tables, ctx, q_lens, layer, ck, cv, cks, cvs)
            sm = 1 / math.sqrt(d)
            got = paged_mqa_prefill_cuda(qg, *kargs, kv_bits=kv_bits, sm_scale=sm)
            got = got.permute(0, 2, 1, 3, 4).reshape(b, c, h, d)
            exp = ref.paged_mqa_prefill_ref(q, *pargs, sm_scale=sm, kv_bits=kv_bits)
            err = max_err(torch, got, exp, ATTN_TOL)
            again = paged_mqa_prefill_cuda(qg, *kargs, kv_bits=kv_bits, sm_scale=sm)
            check(torch.equal(got, again.permute(0, 2, 1, 3, 4).reshape(b, c, h, d)),
                  f"paged prefill kv{kv_bits} C={c}: two runs gave other bits")
            ql = q_lens.tolist()
            visible = sum(n + min(ci + 1, qn) for n, qn in zip(ctx_list, ql) for ci in range(c))
            slots = sum(touched(n, 0) for n in ctx_list)
            # chunk keys j >= q_len are padding that no query sees
            nbytes = (2 * q.numel() * 2 + kv_bytes(sum(ctx_list) + sum(ql), kv_bits)
                      + 4 * (slots + 2 * b))
            b_ms, b_by = bound(nbytes, 4.0 * h * d * visible)
            kg = gathered(kp, ks, tables, kv_bits, ck, cks)
            vg = gathered(vp, vs, tables, kv_bits, cv, cvs)
            s = w * ps
            kpos = torch.cat([torch.arange(s, device="cuda").expand(b, s),
                              ctx[:, None] + torch.arange(c, device="cuda")[None]], 1)
            kval = torch.cat([torch.arange(s, device="cuda")[None] < ctx[:, None],
                              torch.arange(c, device="cuda")[None] < q_lens[:, None]], 1)
            qpos = ctx[:, None] + torch.arange(c, device="cuda")[None]
            mask = (kval[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None]))[:, None]
            qt = q.transpose(1, 2)
            rec = {
                "case": f"kv{kv_bits} B={b} C={c} ctx={ctx_list} q_lens={ql}",
                "max_abs_err": err, "tol": ATTN_TOL, "grid": launch_grid(b, hkv, c, g),
                "ms": timer(lambda: paged_mqa_prefill_cuda(
                    qg, *kargs, kv_bits=kv_bits, sm_scale=sm)),
                "plain_ms": timer(lambda: ref.paged_mqa_prefill_ref(
                    q, *pargs, sm_scale=sm, kv_bits=kv_bits), iters=3),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            note("paged_prefill", rec, (kv_bits, c) == (8, 128))
        del kp, vp, ks, vs
    torch.cuda.empty_cache()
    return summary


def note_case(summary, gpu, name, rec, representative) -> None:
    """Print one phase-2 case; keep the kernel's largest error and, from its
    representative case, the numbers of the kernels line."""
    summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], rec["max_abs_err"])
    if representative:
        summary[name].update({k: rec[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "case")})
    emit({"phase": "kernels", "kernel": name, **rec, "gpu": gpu})


def host_ms(fn, iters: int = 3) -> float:
    """Median host-clock time of a CPU call, in ms."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def ff_tol(k: int, x) -> dict:
    """The FF kernel's unscaled f32 output against its plain version: the
    products x * w are exact in f32, so the two differ only by summation
    order, at most about K f32 rounding steps of the largest |x| * 127."""
    return dict(atol=k * 2.0**-22 * x.float().abs().max().item() * 127, rtol=1e-5)


def cnn_kernel_cases(torch, timer, gpu, summary) -> None:
    """Phase 2 for the CNN path's kernels: the FF-order dequant matmul and
    the int-mode matmul at ResNet18's conv shapes (batch 8)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mpmm import (int_launch_plan, launch_plan, mpmm_cuda, mpmm_ff_cuda,
                                          mpmm_int_cuda)
    from repro_torch.models.cnn_zoo import resnet18_layers
    from repro_torch.quant.pack import pack_int4, unpack_int4

    gen = torch.Generator(device="cuda").manual_seed(2)
    table = {l.name: l for l in resnet18_layers()}
    b = 8

    def dequantized(wd, ws, w_bits):
        return ((unpack_int4(wd, 0) if w_bits == 4 else wd).float() * ws).to(torch.bfloat16)

    def conv2d_ms(conv, w_deq):
        """The whole layer as one library convolution."""
        img, layer = conv
        w_conv = w_deq.reshape(layer.cin, layer.k, layer.k, -1).permute(3, 0, 1, 2)
        w_conv = w_conv.contiguous()
        return timer(lambda: F.conv2d(img, w_conv, stride=layer.stride, padding=layer.padding))

    def ff_case(label, x, wd, ws, w_bits, conv=None, representative=False):
        m, k = x.shape
        n = wd.shape[-1]
        got = mpmm_ff_cuda(x, wd, w_bits=w_bits)
        exp = ref.mpmm_ff_ref(x, wd, w_bits=w_bits)
        tol = ff_tol(k, x)
        err = max_err(torch, got, exp, tol)
        check(torch.equal(got, mpmm_ff_cuda(x, wd, w_bits=w_bits)),
              f"{label}: two FF runs gave other bits")
        out = ops.mpmm(x, wd, ws, w_bits=w_bits, dataflow="ff")
        out_err = max_err(torch, out, ref.mpmm_ref(x, wd, ws, w_bits=w_bits), MPMM_TOL)
        w_deq = dequantized(wd, ws, w_bits)
        b_ms, b_by = bound(m * k * 2 + wd.numel() + m * n * 4, 2.0 * m * n * k)
        plan = launch_plan(m, n, k, stage_k=ref.FF_STAGE_K)
        rec = {
            "case": f"{label} w{w_bits} M={m} K={k} N={n}", "max_abs_err": err, "tol": tol,
            "kernel_plan": {key: plan[key] for key in ("block_m", "splits", "grid")},
            "scaled_bf16_max_abs_err": out_err, "scaled_tol": MPMM_TOL,
            "ms": timer(lambda: mpmm_ff_cuda(x, wd, w_bits=w_bits)),
            "plain_ms": timer(lambda: ref.mpmm_ff_ref(x, wd, w_bits=w_bits), iters=3),
            "library_ms": timer(lambda: torch.matmul(x, w_deq)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        if conv is not None:
            rec["library_conv2d_ms"] = conv2d_ms(conv, w_deq)
        note_case(summary, gpu, "mpmm_ff_dequant", rec, representative)
        return got

    def cf_case(label, x, wd, ws, conv):
        """The CF kernel (csrc/mpmm.cu, tiled) on a CF layer of the CNN path."""
        m, k = x.shape
        n = wd.shape[-1]
        got = mpmm_cuda(x, wd, ws, w_bits=8)
        err = max_err(torch, got, ref.mpmm_ref(x, wd, ws, w_bits=8), MPMM_TOL)
        w_deq = dequantized(wd, ws, 8)
        b_ms, b_by = bound(m * k * 2 + wd.numel() + n * 4 + m * n * 2, 2.0 * m * n * k)
        rec = {
            "case": f"{label} w8 M={m} K={k} N={n}", "max_abs_err": err, "tol": MPMM_TOL,
            "ms": timer(lambda: mpmm_cuda(x, wd, ws, w_bits=8)),
            "plain_ms": timer(lambda: ref.mpmm_ref(x, wd, ws, w_bits=8), iters=3),
            "library_ms": timer(lambda: torch.matmul(x, w_deq)),
            "library_conv2d_ms": conv2d_ms(conv, w_deq),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        note_case(summary, gpu, "mpmm_dequant", rec, False)

    def layer_inputs(layer):
        """Batch-8 bf16 input of a ResNet18 conv: its patches [M, K], the image
        in NCHW for F.conv2d, and float weights [K, N] to quantize."""
        img = torch.randn(b, layer.h, layer.w, layer.cin, generator=gen,
                          device="cuda").to(torch.bfloat16)
        x = ref.conv_patches(img, layer.k, layer.stride, layer.padding)
        x = x.reshape(-1, x.shape[-1]).contiguous()
        w = torch.randn(x.shape[1], layer.cout, generator=gen, device="cuda")
        return x, img.permute(0, 3, 1, 2).contiguous(), w / math.sqrt(x.shape[1])

    # ---- FF dequant at ResNet18's conv shapes, w8 and (where K is even) w4
    for name in FF_LAYERS:
        layer = table[name]
        x, img_nchw, w = layer_inputs(layer)
        for w_bits in (8, 4):
            if w_bits == 4 and x.shape[1] % 2:
                continue  # int4 packs K in pairs (conv1: K = 147)
            wd, ws = ops.pack_weights(w, w_bits)
            ff_case(name, x, wd, ws, w_bits, conv=(img_nchw, layer),
                    representative=(name, w_bits) == ("layer3.1.conv1", 8))
            if (name, w_bits) == ("layer3.1.conv1", 8):  # FF vs CF on one shape
                exp = ref.mpmm_ref(x, wd, ws, w_bits=8)
                ff = ops.mpmm(x, wd, ws, w_bits=8, dataflow="ff")
                cf = mpmm_cuda(x, wd, ws, w_bits=8)
                emit({"phase": "kernels", "kernel": "mpmm_ff_vs_cf", "case": name,
                      "ff_max_abs_err": max_err(torch, ff, exp, MPMM_TOL),
                      "cf_max_abs_err": max_err(torch, cf, exp, MPMM_TOL),
                      "max_abs_diff": max_err(torch, ff, cf, MPMM_TOL), "tol": MPMM_TOL,
                      "ff_ms": timer(lambda: ops.mpmm(x, wd, ws, w_bits=8, dataflow="ff")),
                      "cf_ms": timer(lambda: mpmm_cuda(x, wd, ws, w_bits=8)), "gpu": gpu})
        del x, img_nchw, w
    # ---- CF dequant (csrc/mpmm.cu) at the CF layers of ResNet18 w8 (batch 8)
    for name in CF_LAYERS:
        layer = table[name]
        x, img_nchw, w = layer_inputs(layer)
        wd, ws = ops.pack_weights(w, 8)
        cf_case(name, x, wd, ws, (img_nchw, layer))
        del x, img_nchw, w
    # beside the CF kernel's serving number (W4, M = 8, 3072 x 8192)
    x = torch.randn(8, 3072, generator=gen, device="cuda").to(torch.bfloat16)
    wd, ws = ops.pack_weights(torch.randn(3072, 8192, generator=gen, device="cuda") / 55.4, 4)
    ff_case("serving", x, wd, ws, 4)
    torch.cuda.empty_cache()

    # ---- int mode: bit-exact against the CPU's int32 matmul
    def int_operands(m, k, n, w_bits, x_bits, fill=None):
        def draw(shape, bits):
            if fill is not None:
                return torch.full(shape, fill, dtype=torch.int16, device="cuda")
            lim = 2 ** (bits - 1)
            dt = torch.int16 if bits == 16 else torch.int8
            return torch.randint(-lim, lim, shape, generator=gen, device="cuda", dtype=dt)

        x = draw((m, k), x_bits)
        wq = draw((k, n), w_bits)
        return x, (pack_int4(wq, dim=0) if w_bits == 4 else wq)

    def int_case(label, x, wd, w_bits, dataflow, representative=False):
        m, k = x.shape
        n = wd.shape[-1]
        x_cpu, wd_cpu = x.cpu(), wd.cpu()
        got = mpmm_int_cuda(x, wd, w_bits=w_bits, dataflow=dataflow)
        exp = ref.mpmm_ref(x_cpu, wd_cpu, None, w_bits=w_bits, mode="int")
        check(torch.equal(got.cpu(), exp), f"int mode {label}: kernel != CPU int32 matmul")
        planes = (2 if x.dtype == torch.int16 else 1) * (2 if w_bits == 16 else 1)
        nbytes = x.numel() * x.element_size() + wd.numel() * wd.element_size() + m * n * 4
        b_ms, b_by = bound(nbytes, planes * 2.0 * m * n * k, PEAK_INT8_OPS)
        library_ms = None
        # torch._int_mm: int8 x int8 only, with M > 16 and K, N multiples of 8
        if x.dtype == torch.int8 and w_bits <= 8 and m > 16 and k % 8 == 0 and n % 8 == 0:
            w8 = unpack_int4(wd, 0) if w_bits == 4 else wd
            library_ms = timer(lambda: torch._int_mm(x, w8))
        plan = int_launch_plan(m, n, k, dataflow)
        rec = {
            "case": f"{label} w{w_bits} x{8 * x.element_size()} {dataflow} M={m} K={k} N={n}",
            "max_abs_err": 0.0, "tol": "bit-exact", "plane_pairs": planes,
            "kernel_plan": {key: plan[key] for key in ("block_m", "stage_k", "stages", "grid")},
            "ms": timer(lambda: mpmm_int_cuda(x, wd, w_bits=w_bits, dataflow=dataflow)),
            "plain_ms": host_ms(lambda: ref.mpmm_ref(x_cpu, wd_cpu, None, w_bits=w_bits,
                                                     mode="int")),
            "plain_device": "cpu", "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        note_case(summary, gpu, "mpmm_int", rec, representative)

    int_shapes = [("layer3.1.conv1 b2", 2 * 14 * 14, 2304, 256),
                  ("layer1.0.conv2 b1", 56 * 56, 576, 64),
                  ("conv1 b1", 112 * 112, 147, 64)]
    for label, m, k, n in int_shapes:
        for w_bits, x_bits in INT_GRID:
            if w_bits == 4 and k % 2:
                continue
            x, wd = int_operands(m, k, n, w_bits, x_bits)
            for dataflow in ("cf", "ff"):
                int_case(label, x, wd, w_bits, dataflow, representative=(
                    label, w_bits, x_bits, dataflow) == ("layer3.1.conv1 b2", 8, 16, "ff"))
    # a CF split whose last split is short: 2240 rows = 8 x 256 + 192
    for w_bits, x_bits in ((8, 8), (8, 16)):
        x, wd = int_operands(392, 2240, 256, w_bits, x_bits)
        for dataflow in ("cf", "ff"):
            int_case("short last split", x, wd, w_bits, dataflow)
    x, wd = int_operands(392, 2304, 256, 16, 16, fill=32767)  # every sum wraps mod 2^32
    for dataflow in ("cf", "ff"):
        int_case("all-32767 wraparound", x, wd, 16, dataflow)
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 3
def step_card_vs_cpu(torch, gpu, base) -> None:
    """One prefill chunk and one decode step of ``base`` cut to 2 layers, on
    the card and on the CPU, for three (w_bits, kv_bits) pairs.

    Tolerance: card and CPU sum in other orders, so bf16 values may land a
    rounding step apart, and an int4 KV pool turns such a step into one int4
    step of a K/V value.  The bound is bf16's own error on these inputs: the
    same step run on the CPU in float32 gives the noise of the CPU's bf16
    run; if the card's bf16 run is as close to float32 as the CPU's, the
    triangle inequality puts card and CPU at most twice that far apart (in
    the largest and the mean logit difference).  The argmax must match on
    every row with int8 and 16-bit KV.  With int4 KV one int4 step moves
    logits by far more than the gap between the top two of 128256 random
    logits, so two correct runs may pick different tokens.  Where card and
    CPU disagree on such a row, the float32 run is the witness: it must
    pick one of the two tokens, or both picks must lie within that row's
    bf16 noise (its largest |bf16 - float32| logit) of float32's top logit.
    Each such row is reported with the three picks and the gap."""
    from repro_torch.models import transformer as model_lib
    from repro_torch.serve import decode, prefill

    base = dataclasses.replace(base, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params16 = model_lib.init_params(base, gen)
    ps, n_pages, b, c = 16, 24, 2, 32
    for w_bits, kv_bits in ((4, 8), (16, 16), (8, 4)):
        cfg = dataclasses.replace(base, serve_kv_bits=kv_bits)
        params = params16 if w_bits == 16 else model_lib.quantize_params(params16, w_bits)
        dk = cfg.hd // 2 if kv_bits == 4 else cfg.hd
        shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, dk)
        if kv_bits == 16:
            pools = [torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(2)] + [None, None]
        else:
            pools = [torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                   dtype=torch.int8) for _ in range(2)]
            pools += [torch.rand(*shape[:-1], 1, generator=gen, device="cuda") * 0.02
                      for _ in range(2)]
        tables = torch.arange(2 * 8, dtype=torch.int32, device="cuda").reshape(2, 8) + 3
        tokens = torch.randint(0, cfg.vocab, (b, c), generator=gen, device="cuda")
        next_tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device="cuda")
        q_start = torch.tensor([0, 40], dtype=torch.int32, device="cuda")
        q_lens = torch.tensor([c, c - 5], dtype=torch.int32, device="cuda")
        valid = torch.ones(b, dtype=torch.bool, device="cuda")

        def run(device, wide=False):
            """(prefill logits, decode logits) on ``device``; ``wide`` runs
            the model in float32 (bf16 weights and pools widen exactly)."""
            def to(t):
                if t is None:
                    return None
                t = t.to(device)
                return t.float() if wide and t.dtype == torch.bfloat16 else t

            p = _tree_map(params, to)
            run_cfg = dataclasses.replace(cfg, dtype="float32") if wide else cfg
            pl = [None if x is None else to(x).clone() for x in pools]
            logits_p, _ = prefill.chunk_prefill_step(
                p, to(tokens), to(q_start), to(q_lens), to(tables), *pl, cfg=run_cfg)
            logits_d, _ = decode.paged_decode_step(
                p, to(next_tokens), to(q_start + q_lens), to(tables), to(valid), *pl,
                cfg=run_cfg)
            return logits_p.cpu()[:, : cfg.vocab], logits_d.cpu()[:, : cfg.vocab]

        t0 = time.perf_counter()
        on_card = run("cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = run("cpu")
        t_cpu = time.perf_counter() - t0
        cpu32 = run("cpu", wide=True)
        rec = {"phase": "step", "model": "llama3.2-3b (2 of 28 layers, full width)",
               "w_bits": w_bits, "kv_bits": kv_bits, "batch": b, "chunk": c,
               "card_s": t_card, "cpu_s": t_cpu, "gpu": gpu}
        for i, name in enumerate(("prefill", "decode")):
            compare_logits(torch, rec, name, f"{name} w{w_bits}kv{kv_bits}", on_card[i],
                           cpu[i], cpu32[i], kv_bits)
        emit(rec)
        del params
    del params16


def compare_logits(torch, rec, name, tag, a, e, f, kv_bits) -> None:
    """Card logits ``a`` against the CPU's bf16 ``e`` and float32 ``f`` runs
    of the same step (the rule of phase 3, described there): within twice
    the CPU's bf16 noise, the same argmax on every row with int8 or 16-bit
    KV, and with int4 KV float32 as the witness where card and CPU split."""
    b = a.shape[0]
    check(bool(torch.isfinite(a).all()), f"{tag}: non-finite logits")
    diff, noise = (a - e).abs(), (f - e).abs()
    a_top, e_top, f_top = a.argmax(-1), e.argmax(-1), f.argmax(-1)
    agree = int((a_top == e_top).sum())
    rec.update({f"{name}_max_abs_err": diff.max().item(),
                f"{name}_mean_abs_err": diff.mean().item(),
                f"{name}_bf16_noise_max": noise.max().item(),
                f"{name}_bf16_noise_mean": noise.mean().item(),
                f"{name}_argmax_agree": f"{agree}/{b}",
                f"{name}_card_f32_argmax_agree": f"{int((a_top == f_top).sum())}/{b}"})
    check(diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean(),
          f"{tag}: card vs CPU logits differ by max {diff.max().item():.4g} / "
          f"mean {diff.mean().item():.4g}, over twice the bf16 noise "
          f"{noise.max().item():.4g} / {noise.mean().item():.4g}")
    if kv_bits >= 8:
        check(agree == b, f"{tag}: argmax differs between card and CPU")
        return
    split = []
    for r in torch.nonzero(a_top != e_top).flatten().tolist():
        ta, te, tf = int(a_top[r]), int(e_top[r]), int(f_top[r])
        gap = (f[r, tf] - torch.minimum(f[r, ta], f[r, te])).item()
        row_noise = noise[r].max().item()
        split.append({"row": r, "card": ta, "cpu_bf16": te, "cpu_f32": tf,
                      "f32_gap": gap, "row_bf16_noise": row_noise})
        check(tf in (ta, te) or gap <= row_noise,
              f"{tag} row {r}: card picks {ta}, CPU bf16 {te}, float32 {tf}; "
              f"the picks lie {gap:.4g} below float32's top, over the row's "
              f"bf16 noise {row_noise:.4g}")
    rec[f"{name}_argmax_splits"] = split


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree) if hasattr(tree, "to") else tree


def mqa_kernel_cases(torch, timer, gpu, summary) -> None:
    """Phase 2 for contiguous-cache decode (csrc/mqa_decode.cu) against its
    plain version, with SDPA on the dequantized bf16 K/V as the yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mqa_decode import decode_plan, mqa_decode_cuda
    from repro_torch.quant.pack import unpack_int4

    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, b, s, hkv, g, d, lengths, kv_bits in MQA_CASES:
        h = hkv * g
        kd, ks = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen, device="cuda"),
                                 kv_bits)
        vd, vs = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen, device="cuda"),
                                 kv_bits)
        q = torch.randn(b, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        qg = q.reshape(b, hkv, g, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        sm = 1 / math.sqrt(d)

        def unpacked(t):
            return unpack_int4(t, dim=-1) if kv_bits == 4 else t

        def plain():
            return ref.mqa_decode_ref(q, unpacked(kd), unpacked(vd), ks, vs, lens, sm_scale=sm)

        got = mqa_decode_cuda(qg, kd, vd, ks, vs, lens, kv_bits=kv_bits, sm_scale=sm)
        err = max_err(torch, got.reshape(b, h, d), plain(), ATTN_TOL)
        check(torch.equal(got, mqa_decode_cuda(qg, kd, vd, ks, vs, lens, kv_bits=kv_bits,
                                               sm_scale=sm)),
              f"mqa_decode {label} kv{kv_bits}: two runs gave other bits")
        kg = (unpacked(kd).float() * ks).to(torch.bfloat16).transpose(1, 2)
        vg = (unpacked(vd).float() * vs).to(torch.bfloat16).transpose(1, 2)
        kg = kg.repeat_interleave(g, dim=1).contiguous()
        vg = vg.repeat_interleave(g, dim=1).contiguous()
        mask = (torch.arange(s, device="cuda")[None] < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        live = sum(lengths)
        per_tok = hkv * (d // 2 if kv_bits == 4 else d) + hkv * 4  # payload + scale
        nbytes = 2 * live * per_tok + 2 * q.numel() * 2 + 4 * b
        b_ms, b_by = bound(nbytes, 4.0 * h * d * live)
        rec = {
            "case": f"{label} kv{kv_bits} B={b} S={s} Hkv={hkv} G={g} D={d} "
                    f"lengths={min(lengths)}-{max(lengths)}",
            "max_abs_err": err, "tol": ATTN_TOL, "plan": decode_plan(b, hkv, g, s),
            "ms": timer(lambda: mqa_decode_cuda(qg, kd, vd, ks, vs, lens, kv_bits=kv_bits,
                                                sm_scale=sm)),
            "plain_ms": timer(plain, iters=3),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(q4, kg, vg,
                                                                       attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        note_case(summary, gpu, "mqa_decode", rec,
                  (label, kv_bits) == ("zamba2 serving", 8))
        del kd, vd, ks, vs, kg, vg
    torch.cuda.empty_cache()


def hybrid_step_card_vs_cpu(torch, gpu, base) -> None:
    """zamba2-7b cut to 7 layers at full width (one group of 6 SSM layers,
    the shared attention block, a 1-layer tail), w8/kv8: prefill of 2 x 64
    tokens and two decode steps on the card and on the CPU (bf16 and
    float32), held by compare_logits (the rule of phase 3)."""
    from repro_torch.models import transformer as model_lib

    cfg = dataclasses.replace(base, n_layers=7)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model_lib.quantize_params(model_lib.init_params(cfg, gen), cfg.serve_w_bits)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device="cuda")
    steps = [torch.randint(0, cfg.vocab, (2, 1), generator=gen, device="cuda")
             for _ in range(2)]

    def run(device, dtype="bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = _tree_map(params, lambda t: t.to(device))
        logits, cache = model_lib.prefill(p, {"tokens": tokens.to(device)}, c, 64 + 8)
        out = [logits.cpu()[:, : cfg.vocab]]
        for tok in steps:
            logits, cache = model_lib.decode_step(p, tok.to(device), cache, c)
            out.append(logits.cpu()[:, : cfg.vocab])
        return out

    t0 = time.perf_counter()
    on_card = run("cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run("cpu")
    t_cpu = time.perf_counter() - t0
    cpu32 = run("cpu", "float32")
    rec = {"phase": "step_hybrid", "model": "zamba2-7b (7 of 81 layers, full width)",
           "w_bits": cfg.serve_w_bits, "kv_bits": cfg.serve_kv_bits, "batch": 2,
           "prompt": 64, "decode_steps": 2, "card_s": t_card, "cpu_s": t_cpu, "gpu": gpu}
    for i, name in enumerate(("prefill", "decode1", "decode2")):
        compare_logits(torch, rec, name, f"zamba2 {name}", on_card[i], cpu[i], cpu32[i],
                       cfg.serve_kv_bits)
    emit(rec)
    del params


# --------------------------------------------------------------- waves
def waves_run(torch, seed: int, cfg, requests: int, prompt: int, new: int):
    """Serve ``requests`` greedy requests of ``prompt`` random tokens and
    ``new`` new tokens through the static-wave Server (batch 8, the arch's
    w/kv bits), with weights drawn from ``seed``; returns (streams, stats,
    peak bytes, wall s, server)."""
    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.train.server import Request, Server

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    srv = Server(cfg, params, batch_size=8, max_len=prompt + new + 8, device="cuda")
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt).astype(np.int32),
                    max_new_tokens=new) for i in range(requests)]
    t0 = time.perf_counter()
    srv.serve(reqs)
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.done and len(r.out_tokens) == new, f"request {r.rid}: {len(r.out_tokens)} "
              f"tokens, expected {new}")
        check(all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: token outside the vocabulary (padded logits leaked)")
    return [tuple(r.out_tokens) for r in reqs], srv.stats, torch.cuda.max_memory_allocated(), \
        wall, srv


def waves_profile(torch, srv, cfg, prompt: int) -> dict:
    """Two decode steps of a full wave (8 x ``prompt`` tokens prefilled)
    under torch.profiler: device time by kernel and the card's busy share of
    the unprofiled wall time of two steps."""
    from repro_torch.models import transformer as model_lib

    tokens = torch.randint(0, cfg.vocab, (8, prompt), device="cuda")
    logits, cache = model_lib.prefill(srv.params, {"tokens": tokens}, cfg, srv.max_len)
    tok = logits.argmax(-1)[:, None]

    def two_steps():
        nonlocal logits, cache, tok
        for _ in range(2):
            logits, cache = model_lib.decode_step(srv.params, tok, cache, cfg)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()

    two_steps()  # warm
    t0 = time.perf_counter()
    two_steps()
    wall = time.perf_counter() - t0
    return device_profile(torch, two_steps, wall,
                          sums={"mqa_decode": lambda name: "mqa_decode" in name,
                                "mpmm_decode_m": decode_m_kernel,
                                "mpmm_split_sums": lambda name: "mpmm_splitk_reduce" in name})


def decode_m_kernel(name: str) -> bool:
    """A device kernel of the CF dequant matmul at decode M: the
    tensor-core kernel's 8-row tile (its first template argument)."""
    return re.search(r"mpmm_tc_kernel<(\(int\))?8,", name.replace(" ", "")) is not None


# --------------------------------------------------------------- phase 4
def ff_kernel(name: str) -> bool:
    """A device kernel of the FF dequant order: the tensor-core kernel with
    its FF epilogue (the last template argument) or its f32 stage sum."""
    tc = re.search(r"mpmm_tc_kernel<([^>]*)>", name)
    return bool(tc and tc.group(1).replace(" ", "").endswith(",true")) or \
        "sum_stages<float>" in name


def device_profile(torch, run_once, wall_s: float, sums=None) -> dict:
    """One network run under torch.profiler: device time by kernel (the
    events that ran on the card; a host op's device time would count its
    kernels twice), and the share of the unprofiled wall time ``wall_s`` the
    card was busy (the profiler slows the host, so its own wall time is not
    used for the share).  ``sums`` maps a label to a test of a kernel's full
    name: the device ms and launches of the kernels it picks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
    by_kernel = {}
    picked = {label: {"device_ms": 0.0, "launches": 0} for label in (sums or {})}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.key[:60]] = by_kernel.get(e.key[:60], 0.0) + e.device_time_total
            for label, test in (sums or {}).items():
                if test(e.key):
                    picked[label]["device_ms"] += e.device_time_total / 1e3
                    picked[label]["launches"] += e.count
    busy_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "device_busy_share": busy_ms / (wall_s * 1e3),
            "top_kernels_us": {k: v for k, v in top}, **picked}


def cnn_run(torch, gpu) -> None:
    """The paper's CNN path on the card: ResNet18 through run_network."""
    from repro_torch.core.perfmodel import select_dataflow
    from repro_torch.core.precision import Precision
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    b = 8
    layers, params = cnn.init_network("ResNet18", 0, w_bits=8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(b, 224, 224, 3, generator=gen, device="cuda").to(torch.bfloat16)

    def run(inp, prm, lyr, device="cuda", w_bits=8):
        out, dec = cnn.run_network("ResNet18", inp, prm, lyr, w_bits=w_bits, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, dec

    out, decisions = run(x, params, layers)
    ff = [d for d in decisions if d.endswith(": ff")]
    cf = [d.split(":")[0] for d in decisions if d.endswith(": cf")]
    check(len(ff) == 17 and cf == CF_LAYERS,
          f"ResNet18 w8 decisions: {len(ff)} FF, CF at {cf} (expected 17 FF, the 3 downsamples)")
    check(tuple(out.shape) == (b, 7, 7, 512) and bool(torch.isfinite(out).all()),
          f"ResNet18 output {tuple(out.shape)} is not finite [8, 7, 7, 512]")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run(x, params, layers)
        times.append(time.perf_counter() - t0)
    wall = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(torch, lambda: run(x, params, layers), wall,
                             sums={"ff_dequant": ff_kernel})
    check(profile["ff_dequant"]["launches"] > 0, "the profiled run shows no FF kernel")

    # card vs CPU at batch 2: the CPU's bf16 run against its float32 run is
    # the noise; the card's bf16 run must be as close to the CPU's bf16 run
    # as twice that, in the largest and the mean difference (as in phase 3)
    x2 = x[:2]
    cpu_params = [(wd.cpu(), ws.cpu()) for wd, ws in params]
    card2, _ = run(x2, params, layers)
    t0 = time.perf_counter()
    cpu16, _ = run(x2.cpu(), cpu_params, layers, device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu32, _ = run(x2.cpu().float(), cpu_params, layers, device="cpu")
    card2 = card2.cpu().float()
    diff, noise = (card2 - cpu16.float()).abs(), (cpu32 - cpu16.float()).abs()
    emit({"phase": "cnn", "model": "ResNet18 (20 convs, 224x224x3)", "w_bits": 8,
          "batch": b, "strategy": "mixed", "decisions": decisions,
          "ff_layers": len(ff), "cf_layers": len(cf), "images_per_s": b / wall,
          "wall_ms_p50": wall * 1e3, "peak_mem_gb": peak / 1e9,
          "card_vs_cpu_batch": 2, "max_abs_err": diff.max().item(),
          "mean_abs_err": diff.mean().item(), "bf16_noise_max": noise.max().item(),
          "bf16_noise_mean": noise.mean().item(), "out_abs_max": cpu32.abs().max().item(),
          "card_vs_f32_max": (card2 - cpu32).abs().max().item(), "cpu_bf16_s": cpu_s,
          "profile": profile, "gpu": gpu})
    check(diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean(),
          f"ResNet18 card vs CPU differ by max {diff.max().item():.4g} / mean "
          f"{diff.mean().item():.4g}, over twice the bf16 noise {noise.max().item():.4g} / "
          f"{noise.mean().item():.4g}")
    del card2, cpu16, cpu32, cpu_params

    # w4: init_network raises as the JAX package does (conv1's K = 147 is
    # odd), so layers 2-20 get their w4 weights here
    raised = False
    try:
        cnn.init_network("ResNet18", 0, w_bits=4, device="cuda")
    except ValueError:
        raised = True
    check(raised, "w4 init_network of ResNet18 did not raise ValueError")
    layers4 = layers[1:]
    params4 = [ops.conv_pack_weights(torch.randn(l.k, l.k, l.cin, l.cout, generator=gen,
                                                 device="cuda") / (l.k * l.cin ** 0.5), 4)
               for l in layers4]
    x4 = torch.randn(b, 56, 56, 64, generator=gen, device="cuda").to(torch.bfloat16)
    run(x4, params4, layers4, w_bits=4)
    t0 = time.perf_counter()
    out4, dec4 = run(x4, params4, layers4, w_bits=4)
    wall4 = time.perf_counter() - t0
    check(tuple(out4.shape) == (b, 7, 7, 512) and bool(torch.isfinite(out4).all()),
          "ResNet18 w4 layers 2-20: output not finite [8, 7, 7, 512]")
    emit({"phase": "cnn_w4", "model": "ResNet18 layers 2-20", "w_bits": 4, "batch": b,
          "decisions": dec4, "ff_layers": sum(d.endswith(": ff") for d in dec4),
          "cf_layers": sum(d.endswith(": cf") for d in dec4), "wall_ms": wall4 * 1e3,
          "gpu": gpu})
    del params4, x4, out4

    # int mode: int16 activations x w8 weights, bit-exact against the CPU
    table = dict(zip((l.name for l in layers), zip(layers, params)))
    for name in INT_LAYERS:
        layer, (wd, ws) = table[name]
        xi = torch.randint(-32768, 32768, (2, layer.h, layer.w, layer.cin), generator=gen,
                           device="cuda", dtype=torch.int16)
        kw = dict(w_bits=8, ksize=layer.k, stride=layer.stride, padding=layer.padding,
                  mode="int", dataflow="auto")
        got = ops.mpconv(xi, wd, ws, **kw)
        torch.cuda.synchronize()
        exp = ops.mpconv(xi.cpu(), wd.cpu(), ws.cpu(), **kw)
        check(torch.equal(got.cpu(), exp), f"int-mode mpconv {name}: card != CPU")
        df = select_dataflow(layer, Precision.INT8).name.lower()
        emit({"phase": "cnn_int", "layer": name, "dataflow": df, "batch": 2,
              "x": "int16", "w_bits": 8, "shape": list(got.shape), "bit_exact": True,
              "gpu": gpu})


# --------------------------------------------------------------- phase 5
def engine_run(torch, seed: int, cfg):
    """Serve the phase-4 traffic once; returns (streams, stats, peak bytes, s)."""
    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                         num_pages=8 * 40, device="cuda")
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, 256).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 256).astype(np.int32)])
               for _ in range(8)]

    def submit(i):
        w, kv = PRECISIONS[i % len(PRECISIONS)]
        return engine.submit(prompts[i], SamplingParams(max_new_tokens=32),
                             PrecisionParams(w_bits=w, kv_bits=kv))

    t0 = time.perf_counter()
    # the first request of each precision warms the shared system prompt;
    # the rest arrive once it is cached, as followers of a system prompt do
    first = [submit(i) for i in range(4)]
    while not all(r.out_tokens for r in first):
        engine.step()
    reqs = first + [submit(i) for i in range(4, 8)]
    streams = {r.rid: [] for r in reqs}
    for ev in engine.generate(reqs):
        if hasattr(ev, "token"):
            streams[ev.rid].append(ev.token)
    wall = time.perf_counter() - t0
    for r in reqs:  # tokens emitted before generate() began stream out first
        check(streams[r.rid] == r.out_tokens, f"request {r.rid}: stream != out_tokens")
        check(all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: token outside the vocabulary (padded logits leaked)")
    peak = torch.cuda.max_memory_allocated()
    stats = engine.stats
    del engine, params
    torch.cuda.empty_cache()
    return [tuple(r.out_tokens) for r in reqs], stats, peak, wall


def engine_prefill_profile(torch, cfg) -> dict:
    """One chunk-prefill group call of the full engine under torch.profiler.
    Four w8/kv8 requests of 512 random prompt tokens with a 128-token chunk:
    every engine step prefills one chunk of all four in one group call (one
    chunk_prefill_step of 4 x 128 tokens).  Step 1 warms up, step 2 (128
    tokens of context) is timed without the profiler, step 3 (256 of
    context) runs under it: device time by kernel, and the card's busy share
    of step 2's wall time."""
    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    engine = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                         num_pages=8 * 40, device="cuda")
    rng = np.random.default_rng(7)
    for _ in range(4):
        engine.submit(rng.integers(0, cfg.vocab, 512).astype(np.int32),
                      SamplingParams(max_new_tokens=4), PrecisionParams(w_bits=8, kv_bits=8))

    def step():
        engine.step()
        torch.cuda.synchronize()

    step()
    chunks = engine.stats.prefill_chunks
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    prof = device_profile(torch, step, wall)
    check(engine.stats.prefill_chunks == chunks + 2,
          f"profiled engine steps ran {engine.stats.prefill_chunks - chunks} prefill "
          "group calls, expected one each")
    del engine, params
    torch.cuda.empty_cache()
    return {"requests": 4, "prompt": 512, "chunk": 128, "w_bits": 8, "kv_bits": 8,
            "group_call_ms": wall * 1e3, **prof}


def _p50(samples) -> float:
    ordered = sorted(samples)
    return ordered[len(ordered) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    t_start = time.perf_counter()

    from repro_torch.kernels import _build
    from repro_torch.kernels.mpmm import mpmm_cuda, mpmm_ff_cuda, mpmm_int_cuda
    from repro_torch.kernels.mqa_decode import mqa_decode_cuda
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda

    lib_path = _build.build()
    _build.lib()
    emit({"phase": "build", "lib": lib_path.name, "nvcc_s": _build.last_build_seconds,
          "built_now": _build.last_build_seconds is not None, "gpu": gpu})

    from repro_torch.configs import get_config

    llama = get_config("llama3.2-3b")
    zamba = get_config("zamba2-7b")
    timer = Timer(torch)
    summary = kernel_cases(torch, timer, gpu)
    cnn_kernel_cases(torch, timer, gpu, summary)
    mqa_kernel_cases(torch, timer, gpu, summary)
    step_card_vs_cpu(torch, gpu, llama)
    hybrid_step_card_vs_cpu(torch, gpu, zamba)
    torch.cuda.empty_cache()

    counters = {"mpmm_dequant": mpmm_cuda, "paged_decode": paged_mqa_decode_cuda,
                "paged_prefill": paged_mqa_prefill_cuda, "mpmm_ff_dequant": mpmm_ff_cuda,
                "mpmm_int": mpmm_int_cuda, "mqa_decode": mqa_decode_cuda}

    def count(path):
        """Drive one path with every count at 0; its launches per kernel
        (and, apart, the CF matmul's launches at prefill M)."""
        for fn in counters.values():
            fn.launches = 0
        mpmm_cuda.prefill_m_launches = 0
        result = path()
        launches = {name: fn.launches for name, fn in counters.items()}
        launches["mpmm_dequant_prefill_m"] = mpmm_cuda.prefill_m_launches
        return result, launches

    _, cnn_launches = count(lambda: cnn_run(torch, gpu))
    emit({"phase": "cnn_launches", "launches": cnn_launches, "gpu": gpu})
    torch.cuda.empty_cache()
    (streams, stats, peak, wall), launches = count(lambda: engine_run(torch, 0, llama))
    ttfts = sorted(stats.ttfts)
    emit({"phase": "engine", "model": "llama3.2-3b (28 layers, full width)",
          "requests": 8, "prompt": 512, "shared_prefix": 256, "new_tokens": 32,
          "precisions": PRECISIONS, "tokens_out": stats.tokens_out,
          "decode_tok_per_s": stats.decode_tok_per_s, "decode_s": stats.decode_s,
          "decode_call_ms_p50": _p50(stats.decode_call_s) * 1e3,
          "prefill_s": stats.prefill_s, "wall_s": wall,
          "ttft_ms_first": ttfts[0] * 1e3, "ttft_ms_last": ttfts[-1] * 1e3,
          "prefix_hit_tokens": stats.prefix_hit_tokens,
          "mixed_precision_steps": stats.mixed_precision_steps,
          "preemptions": stats.preemptions, "prefill_chunks": stats.prefill_chunks,
          "decode_group_calls": {f"w{w}kv{k}": n for (w, k), n in stats.group_calls.items()},
          "peak_mem_gb": peak / 1e9, "launches": launches, "gpu": gpu})
    check(stats.tokens_out == 8 * 32, f"tokens_out {stats.tokens_out} != 256")
    check(stats.prefix_hit_tokens > 0, "no prefix-cache hits")
    check(stats.mixed_precision_steps > 0, "no mixed-precision decode steps")
    streams2, stats2, _, wall2 = engine_run(torch, 0, llama)
    check(streams == streams2, "a second run with the same seed gave other streams")
    emit({"phase": "engine_repeat", "identical_streams": True,
          "decode_tok_per_s": stats2.decode_tok_per_s, "decode_s": stats2.decode_s,
          "decode_call_ms_p50": _p50(stats2.decode_call_s) * 1e3,
          "prefill_s": stats2.prefill_s, "wall_s": wall2,
          "ttft_ms_first": min(stats2.ttfts) * 1e3, "ttft_ms_last": max(stats2.ttfts) * 1e3,
          "gpu": gpu})

    torch.cuda.empty_cache()
    emit({"phase": "engine_prefill_profile",
          "what": "one chunk-prefill group call of the full engine (4 x 128 tokens)",
          "profile": engine_prefill_profile(torch, llama), "gpu": gpu})

    # ---- waves: full zamba2-7b through the static-wave Server, twice
    (streams, wstats, wpeak, wwall, srv), wave_launches = count(
        lambda: waves_run(torch, 0, zamba, WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW))
    emit({"phase": "waves", "model": "zamba2-7b (81 layers, full width)",
          "requests": WAVE_REQUESTS, "prompt": WAVE_PROMPT, "new_tokens": WAVE_NEW,
          "batch_size": 8, "w_bits": zamba.serve_w_bits, "kv_bits": zamba.serve_kv_bits,
          "tokens_out": wstats.tokens_out,
          "decode_tok_per_s": wstats.tokens_out / wstats.decode_s,
          "decode_s": wstats.decode_s, "decode_steps": wstats.decode_steps,
          "decode_step_ms": wstats.decode_s / wstats.decode_steps * 1e3,
          "prefill_s": wstats.prefill_s, "wall_s": wwall, "peak_mem_gb": wpeak / 1e9,
          "launches": wave_launches, "gpu": gpu})
    check(wstats.tokens_out == WAVE_REQUESTS * WAVE_NEW,
          f"waves tokens_out {wstats.tokens_out} != {WAVE_REQUESTS * WAVE_NEW}")
    wprof = waves_profile(torch, srv, zamba, WAVE_PROMPT)
    emit({"phase": "waves_profile", "what": "two decode steps of a full wave",
          "profile": wprof, "gpu": gpu})
    check(wprof["mpmm_decode_m"]["launches"] > 0,
          "the profiled decode steps show no decode-M CF matmul")
    del srv
    torch.cuda.empty_cache()
    streams2, wstats2, _, wwall2, srv = waves_run(torch, 0, zamba, WAVE_REQUESTS,
                                                  WAVE_PROMPT, WAVE_NEW)
    del srv
    check(streams == streams2, "a second waves run with the same seed gave other streams")
    emit({"phase": "waves_repeat", "identical_streams": True,
          "decode_tok_per_s": wstats2.tokens_out / wstats2.decode_s,
          "decode_step_ms": wstats2.decode_s / wstats2.decode_steps * 1e3,
          "prefill_s": wstats2.prefill_s, "wall_s": wwall2, "gpu": gpu})
    torch.cuda.empty_cache()

    # ---- the ssm family: full mamba2-130m through the same waves
    mamba = get_config("mamba2-130m")
    (_, mstats, mpeak, mwall, srv), mamba_launches = count(
        lambda: waves_run(torch, 0, mamba, 8, WAVE_PROMPT, WAVE_NEW))
    del srv
    emit({"phase": "waves_ssm", "model": "mamba2-130m (24 layers, full width)",
          "requests": 8, "prompt": WAVE_PROMPT, "new_tokens": WAVE_NEW,
          "tokens_out": mstats.tokens_out,
          "decode_tok_per_s": mstats.tokens_out / mstats.decode_s,
          "decode_step_ms": mstats.decode_s / mstats.decode_steps * 1e3,
          "prefill_s": mstats.prefill_s, "wall_s": mwall, "peak_mem_gb": mpeak / 1e9,
          "launches": mamba_launches, "gpu": gpu})
    check(mamba_launches["mpmm_dequant"] > 0 and mamba_launches["mqa_decode"] == 0,
          f"mamba2-130m launches {mamba_launches}: expected the matmul and no attention")

    by_path = {"serve": launches, "cnn": cnn_launches, "waves": wave_launches,
               "waves_ssm": mamba_launches}
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        s = summary[name]
        # each kernel's launches on its own path: serving (phase 5) for the
        # serving kernels, the CNN (phase 4) for the FF and int matmuls, the
        # zamba2 waves for contiguous-cache decode
        path = KERNEL_PATH[name]
        n = by_path[path][name]
        check(n > 0, f"{name} was never launched on the {path} path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "path": path,
            "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "case": s["case"],
            **({"prefill": {**s["prefill"], "launches": by_path[path]["mpmm_dequant_prefill_m"]}}
               if "prefill" in s else {}),
        })
    print(json.dumps({"kernels": kernels, "total_s": time.perf_counter() - t_start}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
