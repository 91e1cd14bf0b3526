#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and checks it.

    python3 chip_smoke.py

Phases, each printing one JSON line that names the card:

1. build    -- nvcc builds the kernels under src/repro_torch/kernels/csrc.
2. kernels  -- each hand-written kernel against its plain PyTorch version on
               the same inputs, at llama3.2-3b's serving shapes, in bf16:
               max abs error against the stated tolerance, the kernel's time,
               the plain version's, a PyTorch library call's as a yardstick,
               and the least time the card could take (bound_ms).
3. step     -- a 2-layer cut of llama3.2-3b at full width (d_model 3072,
               vocab 128256): one chunked-prefill step and one decode step on
               the card (kernels) and on the CPU (plain versions); the logits
               must agree and pick the same token on every row.
4. engine   -- the full 28-layer llama3.2-3b with seeded random weights
               served by ServeEngine.generate(): 8 greedy requests with
               512-token prompts (256 shared), 32 new tokens each, weight/KV
               precision cycling over (4,8) (8,4) (8,8) (16,16); run twice,
               the streams must be identical.
5. kernels line -- launches of each kernel in phase 4's first run (all > 0).

The last line is {"ok": true, "device": {...}}; any failed check raises and
the script exits nonzero without it.  It exits nonzero too when no CUDA card
is present or when it is run outside a checkout of the repository.
Times come from CUDA events with the L2 cache flushed before every launch
(the serving path finds weights and pages cold); bound_ms is the larger of
the bytes the call must move over 3.35 TB/s and its operations over 989
TFLOP/s (H100 SXM bf16 dense peak, at the full 700 W power limit).
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
MPMM_TOL = dict(atol=2e-2, rtol=1e-2)  # bf16 output: one rounding step each way
ATTN_TOL = dict(atol=1e-2, rtol=1e-2)
MPMM_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]
PRECISIONS = [(4, 8), (8, 4), (8, 8), (16, 16)]

TPU_KERNELS = {
    "mpmm_dequant": ("src/repro_torch/kernels/csrc/mpmm.cu",
                     "src/repro/kernels/mpmm.py:174 (mpmm_pallas, CF dequant)"),
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:153 (paged_mqa_decode_pallas)"),
    "paged_prefill": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill.py:157 (paged_mqa_prefill_pallas)"),
}


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
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
    from repro_torch.kernels.mpmm import mpmm_cuda
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda
    from repro_torch.quant.pack import unpack_int4

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {name: {"max_abs_err": 0.0} for name in TPU_KERNELS}

    def note(name, rec, representative):
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], rec["max_abs_err"])
        if representative:
            summary[name].update({k: rec[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "case")})
        emit({"phase": "kernels", "kernel": name, **rec, "gpu": gpu})

    # ---- mpmm: w4/w8, every (K, N) of the serving path; M covers each
    # decode batch bucket (one kernel instantiation each) and a prefill M
    for w_bits in (4, 8):
        for k, n in MPMM_SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            wd, ws = ops.pack_weights(w, w_bits)
            w_deq = ((unpack_int4(wd, 0) if w_bits == 4 else wd).float() * ws).to(torch.bfloat16)
            del w
            for m in (1, 2, 4, 8, 256):
                x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                got = mpmm_cuda(x, wd, ws, w_bits=w_bits)
                exp = ref.mpmm_ref(x, wd, ws, w_bits=w_bits)
                err = max_err(torch, got, exp, MPMM_TOL)
                nbytes = m * k * 2 + wd.numel() + n * 4 + m * n * 2
                b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
                rec = {
                    "case": f"w{w_bits} M={m} K={k} N={n}", "max_abs_err": err,
                    "tol": MPMM_TOL,
                    "ms": timer(lambda: mpmm_cuda(x, wd, ws, w_bits=w_bits)),
                    "plain_ms": timer(lambda: ref.mpmm_ref(x, wd, ws, w_bits=w_bits), iters=3),
                    "library_ms": timer(lambda: torch.matmul(x, w_deq)),
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                note("mpmm_dequant", rec, (w_bits, m, k, n) == (4, 8, 3072, 8192))
            del wd, ws, w_deq
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
                "max_abs_err": err, "tol": ATTN_TOL,
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
            a, e, f = on_card[i], cpu[i], cpu32[i]
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite logits")
            diff, noise = (a - e).abs(), (f - e).abs()
            a_top, e_top, f_top = a.argmax(-1), e.argmax(-1), f.argmax(-1)
            agree = int((a_top == e_top).sum())
            rec.update({f"{name}_max_abs_err": diff.max().item(),
                        f"{name}_mean_abs_err": diff.mean().item(),
                        f"{name}_bf16_noise_max": noise.max().item(),
                        f"{name}_bf16_noise_mean": noise.mean().item(),
                        f"{name}_argmax_agree": f"{agree}/{b}",
                        f"{name}_card_f32_argmax_agree": f"{int((a_top == f_top).sum())}/{b}"})
            tag = f"{name} w{w_bits}kv{kv_bits}"
            check(diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean(),
                  f"{tag}: card vs CPU logits differ by max {diff.max().item():.4g} / "
                  f"mean {diff.mean().item():.4g}, over twice the bf16 noise "
                  f"{noise.max().item():.4g} / {noise.mean().item():.4g}")
            if kv_bits >= 8:
                check(agree == b, f"{tag}: argmax differs between card and CPU")
                continue
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
        emit(rec)
        del params
    del params16


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree) if hasattr(tree, "to") else tree


# --------------------------------------------------------------- phase 4
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
    from repro_torch.kernels.mpmm import mpmm_cuda
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda

    lib_path = _build.build()
    _build.lib()
    emit({"phase": "build", "lib": lib_path.name, "nvcc_s": _build.last_build_seconds,
          "built_now": _build.last_build_seconds is not None, "gpu": gpu})

    from repro_torch.configs import get_config

    llama = get_config("llama3.2-3b")
    timer = Timer(torch)
    summary = kernel_cases(torch, timer, gpu)
    step_card_vs_cpu(torch, gpu, llama)
    torch.cuda.empty_cache()

    counters = {"mpmm_dequant": mpmm_cuda, "paged_decode": paged_mqa_decode_cuda,
                "paged_prefill": paged_mqa_prefill_cuda}
    for fn in counters.values():
        fn.launches = 0
    streams, stats, peak, wall = engine_run(torch, 0, llama)
    launches = {name: fn.launches for name, fn in counters.items()}
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

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        s = summary[name]
        check(launches[name] > 0, f"{name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "case": s["case"],
        })
    print(json.dumps({"kernels": kernels, "total_s": time.perf_counter() - t_start}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
