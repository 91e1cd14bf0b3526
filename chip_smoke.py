#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and checks it.

    python3 chip_smoke.py

Phases, each printing one JSON line that names the card:

1. build    -- nvcc builds the kernels under src/repro_torch/kernels/csrc;
               ptxas -v's registers and spill bytes of paged prefill at
               DP = 256, of the f32 kernels of both paged attentions
               (prefill: every DP, kv_bits and row warps, and its merge;
               decode: both NC) and of mqa_decode's wide instantiation
               (DMAX = 256, head dims 129-256) (lines "phase": "ptxas").
2. kernels  -- each hand-written kernel against its plain PyTorch version on
               the same inputs, in bf16 at llama3.2-3b's serving shapes (the
               CF dequant matmul at decode M 1-8, at a speculative round's
               verify M of 40 and at the prefill M of 128 and 256, at
               mixtral-8x22b's expert products (6144 -> 16384 and 16384 ->
               6144) at the engine's expert rows M = 1, 2 and 160, and at
               zamba2-7b's in_proj / out_proj at M = 4096; paged prefill at
               C 1, 32, 128 and at a verify window, C = 5 at B = 8, and at
               gemma3-1b's heads, 1 x 4 x 256, at ctx ~1536, C 128 and C 5,
               with and without its window of 1024, and at D = 192, which
               pads to 256; two runs of the matmul at every M and of paged
               prefill must give the same bits) and at
               ResNet18's conv shapes (the FF-order dequant matmul), and
               bit-exactly against the CPU's int32 matmul (the int-mode
               matmul, also under a CF K split with a short last split); the
               CF dequant matmul also at ResNet18's three CF layers (the 1x1
               stride-2 downsample convs): max abs error against the stated
               tolerance, the kernel's time, the plain version's, a PyTorch
               library call's as a yardstick, and the least time the card
               could take (bound_ms).  The dequant matmul's f32-activation
               entries (the CNN path and the quickstart run float32):
               the CF order at ResNet18's CF layers and at rows 3a / 3b's
               serving shapes (W4 M 8 3072 -> 8192, w8 M 256 3072 -> 3072),
               the FF order at ResNet18's FF layers, against their plain
               versions within x's split error (x in two TF32 terms: hi
               + lo is x within 2^-22 |x|) and f32 summation order, their
               bound for an f32-accurate product (three bf16 terms of x at
               989 TFLOP/s; beside it this kernel's two TF32 passes at
               494.7 and one pass at the f32 rate, 67 TFLOP/s) and
               torch.mm in full f32 on weights dequantized beforehand as
               the library call.  The f32 instantiations of paged decode
               and paged prefill (a float32 model: f32 q and out, f32
               16-bit pools) at llama3.2-3b's heads (decode ctx 0, 1, 17,
               1024 with and without a window of 256, and a row at its
               table's end; prefill C 1, 5 and 128), gemma3-1b's (1 x 4 x
               256, window 1024: decode, C 128 and a verify window, and D
               192) and paligemma-3b's (1 x 8 x 256: decode and a verify
               window), kv4 / kv8 / kv16, against their f32 plain versions
               within F32_ATTN_TOL (two prefill runs the same bits), with
               the error the same kernel gives on q rounded to bf16
               beside it (at least ten times the kernel's wherever a
               cached position counts), each case's plan (splits, merge
               launches) and its instantiation's ptxas registers / spills,
               their bound three bf16 passes of the products
               (bound_f32_ms: one pass at the f32 FMA rate) and SDPA in
               f32 as the library call.
               Then the sampler
               (ops.sample_tokens, plain torch ops) on the card against the
               CPU at llama3.2-3b's vocabulary: bit-equal keys and uniforms,
               equal tokens away from CDF boundaries.
3. step     -- a 2-layer cut of llama3.2-3b at full width (d_model 3072,
               vocab 128256): one chunked-prefill step and one decode step on
               the card (kernels) and on the CPU (plain versions); the logits
               must agree and pick the same token on every row.  The card
               runs the same steps in float32 (dtype="float32": the f32
               paged instantiations, the f32-activation matmul), held to the
               CPU's float32 run within F32_LOGIT_RULE of the bf16 noise
               (compare_logits_f32); so do phases 7 and 8's card-vs-CPU
               cuts and the zamba2-7b hybrid step.
4. cnn      -- the paper's CNN path: full ResNet18 (20 convs, 224x224x3
               input, batch 8, w8, the mixed FF/CF strategy) through
               models.cnn.run_network in float32, as the JAX example runs
               it (the f32-activation entries): per-layer decisions (17 FF /
               3 CF), images/s, peak memory, the f32 kernel's device time
               and launches in one profiled run, card vs CPU at batch 2
               within CNN_F32_RTOL of the output's largest value; the same
               in bf16 (the bf16 kernels; bf16 card vs bf16 and float32
               CPU); the entry point itself (launch.cnn --net ResNet18
               --layers 20) on the card against --device cpu; a w4 run
               over layers 2-20; three layers
               through ops.mpconv(mode="int") on int16 activations, bit-exact
               against the CPU.
5. engine   -- the full 28-layer llama3.2-3b with seeded random weights
               served by ServeEngine.generate(): 8 greedy requests with
               512-token prompts (256 shared), 32 new tokens each, weight/KV
               precision cycling over (4,8) (8,4) (8,8) (16,16); run twice,
               the streams must be identical; then one chunk-prefill group
               call (4 x 128 tokens, w8/kv8) under the profiler, and one
               decode step (8 rows, w8/kv8, ctx ~515) under it: paged
               decode's device time and launches, the card's busy share.
               Then (a) the same traffic sampled (temperature 0.8, top_p
               0.95, top_k 50 on every other request, seed = index), twice:
               identical streams; (b) greedy speculation (spec_k 4) at
               w8/kv8 with a w8 and a w4 draft: acceptance rate, tokens per
               round, agreement with the spec-off streams; the w8 draft
               must accept at least half its drafts; (c) sampled
               speculation (temperature 0.8, w4 draft), twice: identical
               streams; (d) one spec round under the profiler (8 rows, w8
               target, w4 draft, kv8): verify and draft device times and
               launches, the card's busy share; (e) float32
               (dataclasses.replace(cfg, dtype="float32")): the same 8
               requests, (w, kv) over PRECISIONS, greedy on even requests
               and sampled on odd ones, spec_k 4 (w4 draft) on requests
               4-7, twice captured (identical streams) and once eager
               (identical streams and launches); only the f32 paged
               instantiations and the f32-activation matmul may launch;
               decode tokens/s, TTFT, peak memory and the paged launches a
               captured step holds, beside the same traffic in bf16.
6. waves    -- the full 81-layer zamba2-7b (hybrid: Mamba2 + shared
               attention) with seeded random weights served by the
               static-wave train.server.Server: 8 greedy requests of 512
               random tokens, 32 new tokens each, batch 8, w8/kv8; run
               twice, the streams must be identical; two decode steps
               profiled (the device time and launches of mqa_decode and of
               the CF matmul's decode-M tile among them);
               then full mamba2-130m (ssm) served the same way.
               Phases 5 and 6 run their steps captured (serve/graphs.py:
               CUDA graphs, the default); each path (greedy mixed
               precision, sampled, greedy spec with a w8 and a w4 draft,
               sampled spec, the zamba2-7b and mamba2-130m waves) runs once
               more with every step eager (graphs.disable_capture()): the
               streams and the kernel launches must be identical.  Each of
               the four profiles (chunk group call, decode step, spec
               round, wave decode steps) runs captured and eager; a
               captured step also gets the CUDA-event time of one replay of
               its graph, which stands for its busy time where the profiler
               shows the replay only as cudaGraphLaunch.  A summary line
               sets captured against eager: wall and busy ms per step,
               decode tokens/s, peak memory, graphs captured and the
               seconds spent capturing.
7. models   -- the MoE family and the last dense configs, seeded random
               weights: gemma3-1b cut to 6 of 26 layers (5 local + 1
               global) at full width, one chunk (C 128 at ctx 1100 / 1300,
               so the 1024 window binds) and one decode step card vs CPU by
               phase 3's rule, near-tied rows witnessed by float32 and by
               the card with plain paged attention (compare_logits);
               mixtral-8x22b cut to 2 of 56 layers at full width, the same
               step card vs CPU by phase 3's rule (routing and experts on
               both); full gemma3-1b through ServeEngine, 8 greedy
               requests of 1536 tokens, 16 new, (w, kv) over (4,8) (8,8),
               and a greedy spec run (w8 target, w4 draft, spec_k 4) whose
               verify runs paged prefill at D = 256; mixtral-8x22b at full
               width cut to 4 of 56 layers, 8 greedy requests of 512
               tokens, 16 new, (w, kv) over (4,8) (8,8) (16,16), then a
               third, eager run instrumented to count per engine step the
               CF launches, those made inside the MoE FFNs and the top-k
               assignments dropped at capacity (its times not reported); full
               minitron-4b, 2 requests, 8 new, w8/kv8; and reduced
               kimi-k2-1t-a32b through the static waves, a path check of
               its first_dense block and of mqa_decode.  Each runs captured
               and once more eager (identical streams and launches).
8. prefix   -- the vlm and audio archs through the engine's one-shot prefix
               prefill, seeded random weights: paligemma-3b cut to 2 of 18
               layers at full width, the one-shot prefill (256 prefix
               embeddings + 32 tokens, its cache written into pages by
               PagedKVCache.write_prompt) and one decode step card vs CPU by
               phase 3's rule, near-tied rows witnessed as for gemma3-1b; the
               prefix drawn on the card against the CPU's draw; full
               paligemma-3b through ServeEngine, 8 greedy requests of 512
               tokens after its 256 prefix embeddings, 32 new, (w, kv) over
               (4,8) (8,8) (16,16), twice (identical streams), and a greedy
               spec run (w8 target, w4 draft, spec_k 4: paged prefill at
               1 x 8 x 256 in every verify); full musicgen-medium, 8
               requests of 512 after 64 prefix embeddings, 32 new, (w, kv)
               over (8,8) (4,4) (paged decode at G = 1); each captured and
               once more eager (identical streams and launches).  Then the
               paper's executable core on the card: SAU(bit_accurate=True)
               and pe_multiply on CUDA tensors bit-equal to the CPU at INT4 /
               INT8 / INT16, and a 16 -> 16 channel 3x3 conv assembled by
               core.assembler.assemble_conv and run by
               core.interpreter.run_program on the CPU, bit-equal to the same
               layer through the int-mode matmul on the card (its patches as
               ops.mpconv forms them), FF and CF, at each precision.
9. train    -- the training path (no TPU kernel lies on it; its launches
               of the five must all be 0, "train" in ``launches_by_path``;
               Trainer captures its step as one CUDA graph, and (a) and (b)
               run each Trainer twice, captured and under
               graphs.disable_capture(), which must give the same bits):
               (c) llama3.2-3b cut to 2 layers at full width, batch 1 x 64,
               one train step's gradients on the card (bf16), on the CPU in
               bf16 and in float32, then adamw, adamw8bit and adafactor
               applied to each; each token's NLL, every gradient leaf and
               every updated leaf within twice the CPU's bf16 noise
               (phase 3's rule), the adamw8bit codes likewise by the share
               that differs; (a) full llama3.2-3b (28 layers, adamw, remat
               "full"), TRAIN_STEPS steps of Trainer at the JAX launcher's
               defaults (batch 8 x 512, lr 3e-4), captured (step 0 eager,
               then one capture and replays) and eager: losses, grad norms
               and final params bit-equal; for each, seconds a step (median
               after step 0, which holds the warm-up and the capture),
               tokens/s, MFU, peak memory, the bound, the capture seconds,
               and one more step profiled (the card's busy share, its top
               kernels); (b) full mamba2-130m through Trainer with
               checkpoints, driven by run_with_restarts as launch/train.py
               drives it: 12 steps, a checkpoint every 4, one run
               uninterrupted captured, one eager (bit-equal to it), and one
               captured failing at step 6 and resuming from step 4 (the
               restore written into the tensors the graph holds): the final
               params and state bit-equal, every loss of the seed equal; s a
               step, busy share, capture seconds and peak of both modes; the
               checkpoint's bytes and seconds.
10. mesh    -- the multi-device modules over a real NCCL process group of
               world size 1 (one card; NCCL refuses two ranks on one GPU;
               no TPU kernel on the path: "mesh" in ``launches_by_path``,
               all 0): (a) full llama3.2-3b, MESH_TRAIN_STEPS steps at 8 x 512
               through a Trainer on a 1 x 1 mesh under the FSDP mapping
               (set_mesh(mesh, data_only=True); adamw, no checkpoints), each
               step's loss and grad norm within MESH_TRAIN_RTOL of the
               unsharded Trainer's on the card (same seed, data and
               deterministic kernels), s a step, peak memory;
               (b) compressed_grad_reduce over llama3.2-3b's largest leaf
               shapes (embed, unembed, blocks/wo; f32, 1.05e9 elements) and
               two small leaves, card (NCCL) vs CPU (gloo): int8 payloads and
               scales bit for bit, mean and error state within MESH_COLL_RTOL;
               (c) moe_ffn alltoall at mixtral-8x22b's widths (D 6144, F
               16384, 8 experts, top-2, bf16, 1024 tokens) on a 1 x 1 mesh,
               bit-equal to the replicated dispatch; (d) a one-stage
               pipeline_apply at width 3072, bit-equal to the stage applied;
               (e) llama3.2-3b cut to 2 layers at full width: its params
               placed on the 1 x 1 mesh (every block and every gather the
               tensor itself), saved, restored with shardings=, bit-equal.
11. tp      -- the tensor-parallel mapping (JAX's set_mesh(mesh)) over an
               NCCL group of world size 1, where every collective spans one
               rank: (a) full llama3.2-3b, MESH_TRAIN_STEPS steps at 8 x 512
               through launch/train.py --mesh-data 1 --mesh-model 1, which
               installs it, held to phase 10's unsharded Trainer within
               MESH_TRAIN_RTOL; (b) mixtral-8x22b cut to TP_MOE_LAYERS layer
               at full width, TP_MOE_STEPS steps at TP_MOE_BATCH x 512
               through a Trainer on the 1 x 1 mesh under it, held to the
               unsharded Trainer the same way, with its peak memory and the
               share of assignments dropped at capacity; (c) zamba2-7b cut
               to TP_WAVE_LAYERS layers at full width (w8, kv8) through
               Server(mesh=), 8 greedy requests of 512 tokens and 32 new:
               streams equal to the no-mesh Server's (run just before the
               counts are set to 0), tokens/s of both.  The CF matmul and
               mqa_decode must launch on these paths ("tp").  Phase 2 also
               holds the CF matmul at one rank's blocks of llama3.2-3b's W8
               projections on a 4-wide model axis (TP_BLOCK_SHAPES at M 8
               and 256), the row blocks (wo, wd) also through the f32 entry
               a row-split partial takes (held to mpmm_ref's f32 sum, and
               cast to bf16 equal to the bf16 entry's bits), and mqa_decode
               at zamba2-7b's 8 of 32 kv heads: the kernels line carries
               them as "tp_blocks", "tp_partials" and "tp_heads".  In
               Server(mesh=) every W8 row-split projection runs through the
               f32 entry (one rank: the same bits as the unsplit product).
12. dryrun  -- the dry run (src/repro_torch/launch/dryrun.py) against the
               card: (a) each phase-2 case of the CF matmul and of
               mqa_decode through its meta contract, which must return the
               kernel's output shape and dtype and launch nothing; (b) the
               dry run of full llama3.2-3b's phase-9 train step (8 x 512,
               FSDP mapping) and of its W4 / kv8 static-wave decode_step
               (DRYRUN_DECODE_ROWS rows, a full cache of DRYRUN_DECODE_CTX,
               TP mapping), and of full paligemma-3b's W8 / kv8 decode_step
               at the same rows and cache (mqa_decode at head dim 256), over
               a fake group of one rank, each held against the same program
               on the card over NCCL at world size 1, run eagerly
               (graphs.disable_capture(): the cost count is a dispatch mode,
               which a graph replay would bypass):
               FLOPs equal to the cost count of the card's run, argument
               bytes within DRYRUN_ARG_RTOL of the placement's, the peak
               within DRYRUN_PEAK_RTOL of max_memory_allocated, the
               outputs' bytes equal and the card's finite; the roofline's
               bound printed beside the measured time.  The CF
               matmul and mqa_decode must launch on it ("dryrun").
13. examples -- the port's three examples on the card, as a user runs them
               (src/repro_torch/examples): quickstart (the 16-bit product
               bit-exact, the ISA programs, the selector, the W4 matmul on
               float32 activations with the selector's dataflow, CF: the
               f32 CF entry), serve_quantized (W4 + W8 + bf16
               requests in one ServeEngine, streamed, its own assertions)
               and train_lm (the JAX example's 8-layer llama through
               run_with_restarts and the captured Trainer,
               EXAMPLE_TRAIN_STEPS steps, the loss falling); the CF
               matmul and both paged kernels must launch on them
               ("examples"), each one's wall seconds printed.
14. engine_tp -- the paged engine on a mesh: ServeEngine(mesh=) on a 1 x 1
               (data, model) mesh over an NCCL group of one rank, under the
               tensor-parallel mapping with every row on every rank, captured:
               (a) full llama3.2-3b with phase 5's (w, kv) cycle, requests
               4-7 speculative (spec_k 4, a w4 draft); (b) mixtral-8x22b cut
               to TP_MOE_LAYERS layer(s) at full width; (c) full paligemma-3b
               and full musicgen-medium through the one-shot prefix prefill
               under the mapping, TP_PREFIX_REQUESTS requests of
               TP_PREFIX_PROMPT tokens, phase 8's (w, kv) cycles, every
               other request speculative.  Streams equal to the
               unmeshed engine's on the same traffic (run just before the
               counts are set to 0), the eager streams and launches equal to
               the captured ones, every captured step's key naming the
               split; meshed and unmeshed decode tokens/s, captures and
               capture seconds.  The three serving kernels must launch on
               every path ("engine_tp", "engine_tp_moe", "engine_tp_paligemma",
               "engine_tp_musicgen").  Phase 2 also
               holds paged decode (ctx 1024) and paged prefill (a 128-token
               chunk and a verify window) at one rank's kv heads of
               llama3.2-3b on a 2-wide model axis (4 x 3 x 128, kv8 / kv4 /
               bf16): "tp_kv_heads" and "tp_kv_heads_verify" in the kernels
               line.
15. kernels line -- each kernel's launches on its path (all > 0): the serving
               kernels in phase 5's first run, the f32 paged instantiations
               in phase 5(e)'s first float32 run (their other shapes under
               "shapes"), the FF and int matmuls and
               the two f32-activation entries in phase 4, contiguous-cache decode in phase 6's first zamba2
               run; the counts are set to 0 just before each path runs, and
               a replayed step adds the launches its graph holds.  The
               serving kernels must also launch on each of phase 5's sampled
               and spec paths and on phase 7's engine paths (counted apart:
               ``launches_by_path``); the CF matmul and paged prefill carry
               their verify case, paged prefill its D = 256 case (with its
               launches on the gemma3-1b paths) and the CF matmul its
               cases at the experts' shapes and the launches made inside
               the MoE FFNs on the mixtral path; paged decode its cases at
               musicgen-medium's heads (24 x 1 x 64) and paligemma-3b's (1 x 8
               x 256) with their launches on those paths, paged prefill its
               paligemma-3b verify case with the launches on that spec path.

Phase 2 holds paged decode at llama3.2-3b's heads (8 x 3 x 128; ctx 0, 1,
17, 1024, with and without a window of 256), yi-9b's (4 x 8 x 128, ctx 1024,
kv8 and kv4), gemma3-1b's (1 x 4 x 256, a window of 1024 at ctx 2048),
musicgen-medium's (24 x 1 x 64, ctx 600, kv8 and kv4) and paligemma-3b's (1
x 8 x 256, ctx 784); paged prefill also at paligemma-3b's verify window.
It also holds contiguous-cache decode (mqa_decode) against its plain
version at zamba2-7b's serving shape (kv8 and kv4), a 32k context,
llama3.2-3b's GQA shape and paligemma-3b's heads (1 x 8 x 256, one rank's
8 rows of decode_32k: the wide instantiation; "paligemma_heads" in the
kernels line); phase 3 also runs zamba2-7b cut to 7 layers at full
width (prefill and two decode steps) on the card and on the CPU.

The last line is {"ok": true, "device": {...}}; any failed check raises and
the script exits nonzero without it.  It exits nonzero too when no CUDA card
is present or when it is run outside a checkout of the repository.
Times come from CUDA events with the L2 cache flushed before every launch
(the serving path finds weights and pages cold); bound_ms is the larger of
the bytes the call must move over 3.35 TB/s and its operations over 989
TFLOP/s (H100 SXM bf16 dense peak, at the full 700 W power limit), or, for
the int-mode matmul, its int8 tensor-core operations (one pass per pair of
radix-256 digit planes) over 1979 TOP/s, and for the f32-activation
entries, the least work for an f32-accurate product with integer weights:
three bf16 terms of x (each element keeps its own exponent) against the
weights, exact in bf16, at 989 TFLOP/s.  Beside it, bound_tf32_ms is the
two TF32 passes this kernel makes at 494.7 TFLOP/s and bound_f32_ms one
pass over 67 TFLOP/s, outside the tensor cores.  The int-mode plain
version runs on the CPU (CUDA has no int32 matmul), so its plain_ms is a
host-clock time on the CPU.
"""
from __future__ import annotations

import contextlib
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
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores (H100 SXM)
PEAK_TF32_FLOPS = 494.7e12  # TF32 on the tensor cores, dense (H100 SXM)
MPMM_TOL = dict(atol=2e-2, rtol=1e-2)  # bf16 output: one rounding step each way
ATTN_TOL = dict(atol=1e-2, rtol=1e-2)
# the f32 instantiations of the paged kernels against their f32 plain
# versions: f32 summation order only (a q rounded to bf16 misses it)
F32_ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
# float32 card vs float32 CPU logits (phases 3, 7, 8 and the hybrid step):
# max and mean |card - CPU| within F32_LOGIT_RULE x the CPU's bf16 noise,
# ten times tighter than compare_logits' 2x; the same argmax on every row
# whose float32 top-two gap exceeds F32_LOGIT_RULE x the largest noise
F32_LOGIT_RULE = 0.2
MPMM_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]
PRECISIONS = [(4, 8), (8, 4), (8, 8), (16, 16)]
# zamba2-7b's in_proj (d_model -> 2 * d_inner + 2 * state + heads) and
# out_proj (d_inner -> d_model) as (K, N), run at its prefill M (8 x 512)
ZAMBA_PREFILL_SHAPES = [(3584, 14576), (7168, 3584)]
# the CF kernel's prefill-M case of the kernels line: (w_bits, M, K, N)
PREFILL_MPMM_CASE = (8, 256, 3072, 3072)
# mixtral-8x22b's expert products as (K, N): gate / up (d_model -> d_ff) and
# down (d_ff -> d_model), at the engine's expert rows M = cap =
# max(1, T * top_k * 1.25 // 8): 1 and 2 in a decode step (a precision
# group of 4 or 8 rows), 160 in a chunk group call (4 x 128 tokens)
MIXTRAL_EXPERT_SHAPES = [(6144, 16384), (16384, 6144)]
MIXTRAL_EXPERT_M = (1, 2, 160)
# the expert call sites' cases of the kernels line: (w_bits, M, K, N)
EXPERT_MPMM_CASES = {"decode": (4, 2, 6144, 16384), "prefill": (4, 160, 6144, 16384)}
# one rank's blocks of llama3.2-3b's W8 projections on a 4-wide model axis
# under the tensor-parallel mapping, as (K, N): wq's columns (3072 x 768),
# wo's rows (768 x 3072), wg's columns (3072 x 2048), wd's rows (2048 x
# 3072), at a decode M (8) and a prefill M (256)
TP_BLOCK_SHAPES = {"wq columns": (3072, 768), "wo rows": (768, 3072),
                   "wg columns": (3072, 2048), "wd rows": (2048, 3072)}
TP_BLOCK_M = (8, 256)
# speculative decoding in phase 5: draft tokens per round, and the rows of a
# round's verify matmul at 8 rows (8 x (SPEC_K + 1) = 40)
SPEC_K = 4
VERIFY_M = 8 * (SPEC_K + 1)
# its verify-M case of the kernels line: (w_bits, M, K, N)
VERIFY_MPMM_CASE = (8, VERIFY_M, 3072, 3072)
# phase 2's verify window: round-start contexts 512-1024 and q_lens
# n_draft + 1 in 1..5, with a padding row (no context, q_len 0) as the
# engine's pow2 bucket gives one
VERIFY_CTX = [512, 1024, 700, 513, 1000, 640, 901, 0]
VERIFY_Q_LENS = [1, 2, 3, 4, 5, 5, 3, 0]

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
    "mpmm_dequant_x32": ("src/repro_torch/kernels/csrc/mpmm.cu",
                         "src/repro/kernels/mpmm.py:174 (mpmm_pallas, CF dequant on f32 x: "
                         "_mpmm_cf_kernel :115, pallas_call :216)"),
    "mpmm_ff_dequant_x32": ("src/repro_torch/kernels/csrc/mpmm.cu",
                            "src/repro/kernels/mpmm.py:174 (mpmm_pallas, FF dequant on f32 x: "
                            "_mpmm_ff_kernel :148, pallas_call :244)"),
    "paged_decode_f32": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                         "src/repro/kernels/paged_decode.py:153 (paged_mqa_decode_pallas on an "
                         "f32 q: _paged_kernel :51, its f32 cast :86, pallas_call :244)"),
    "paged_prefill_f32": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                          "src/repro/kernels/paged_prefill.py:157 (paged_mqa_prefill_pallas on "
                          "an f32 q: _prefill_kernel :49, its f32 cast :88, pallas_call :245)"),
}
# the profiled spec round's sum that counts each kernel's verify launches
VERIFY_PROF = {"mpmm_dequant": "mpmm_verify_m", "paged_prefill": "paged_prefill_verify"}
# the path each kernel's launches are read from in the kernels line
KERNEL_PATH = {"mpmm_dequant": "serve", "paged_decode": "serve", "paged_prefill": "serve",
               "mpmm_ff_dequant": "cnn", "mpmm_int": "cnn", "mqa_decode": "waves",
               "mpmm_dequant_x32": "cnn", "mpmm_ff_dequant_x32": "cnn",
               "paged_decode_f32": "serve_f32", "paged_prefill_f32": "serve_f32"}
# phase 2 mqa_decode cases: (label, B, S, Hkv, G, D, lengths, kv_bits); zamba2-7b
# serving (S = 512 prompt + 32 new + 8), a long context, llama3.2-3b's GQA, and
# the shape and plan of phase 12's llama3.2-3b decode step (one rank's 8 rows
# of decode_32k)
MQA_CASES = [
    ("zamba2 serving", 8, 552, 32, 1, 112, list(range(545, 553)), 8),
    ("zamba2 serving", 8, 552, 32, 1, 112, list(range(545, 553)), 4),
    ("zamba2 long context", 1, 32768, 32, 1, 112, [32768], 8),
    ("llama3.2-3b GQA", 8, 1024, 8, 3, 128, [1024 - (i % 3) for i in range(8)], 8),
    # one rank's 8 of zamba2-7b's 32 kv heads on a 4-wide model axis (TP)
    ("zamba2 TP 8 of 32 heads", 8, 552, 8, 1, 112, list(range(545, 553)), 8),
    ("llama3.2-3b decode_32k, one rank", 8, 32768, 8, 3, 128,
     [32768 - (i % 3) for i in range(8)], 8),
    # paligemma-3b's heads at head dim 256 (the wide instantiation), the same
    # rank's rows of decode_32k
    ("paligemma-3b decode_32k, one rank", 8, 32768, 1, 8, 256,
     [32768 - (i % 3) for i in range(8)], 8),
]
WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW = 8, 512, 32
# the ResNet18 convs phase 2 times the FF matmul at (batch 8): M = 8*Ho*Wo
FF_LAYERS = ["conv1", "layer1.0.conv2", "layer3.1.conv1", "layer4.1.conv1"]
CF_LAYERS = ["layer2.0.down", "layer3.0.down", "layer4.0.down"]  # the CF layers at w8
# the f32-activation entries' phase-2 cases beside their ResNet18 layers:
# the CF order at rows 3a / 3b's serving shapes, (w_bits, M, K, N)
X32_SERVING_CASES = {"3a": (4, 8, 3072, 8192), "3b": (8, 256, 3072, 3072)}
# phase 4's float32 CNN run against the CPU: f32 summation order only, so
# within 1e-4 of the output's largest value (as the CPU run is held to JAX's)
CNN_F32_RTOL = 1e-4
INT_GRID = [(16, 16), (8, 8), (4, 8), (8, 16), (16, 8)]  # (w_bits, x_bits)
INT_LAYERS = ["conv1", "layer2.0.down", "layer4.1.conv2"]  # phase 4 int mode: FF, CF, FF
# gemma3-1b's attention (Hkv 1, G 4, head_dim 256, a 1024 window on 5 of 6
# layers) in phase 2's paged prefill cases: ctx ~1536 (the engine phase's
# prompt length), a 128-token chunk and a verify window
GEMMA_HEADS = (1, 4, 256)
GEMMA_WINDOW = 1024
GEMMA_PREFILL_CTX = [1536, 1480, 1300, 1536]
GEMMA_PREFILL_Q_LENS = [128, 127, 64, 1]
GEMMA_VERIFY_CTX = [1536, 1530, 1400, 1100, 1536, 1200, 1300, 0]
# phase 7: gemma3-1b's 1536-token prompts (so its window of 1024 binds on
# the local layers), mixtral-8x22b cut to 4 of 56 layers at full width
GEMMA_PROMPT = 1536
GEMMA_PRECISIONS = [(4, 8), (8, 8)]
MIXTRAL_LAYERS = 4
MIXTRAL_PROMPT = 512
MIXTRAL_PRECISIONS = [(4, 8), (8, 8), (16, 16)]
# phase 8: the archs with a frontend prefix, served through the one-shot
# prefill: 512-token prompts after the prefix (256 embeddings for
# paligemma-3b, 64 for musicgen-medium), 32 new tokens
PREFIX_PROMPT, PREFIX_NEW = 512, 32
PALI_PRECISIONS = [(4, 8), (8, 8), (16, 16)]
MUSIC_PRECISIONS = [(8, 8), (4, 4)]
# their attention in phase 2: paged decode at a served context (prefix +
# prompt + some new tokens), paged prefill at paligemma-3b's verify window
MUSIC_HEADS, MUSIC_DECODE_CTX = (24, 1, 64), 600
PALI_HEADS, PALI_DECODE_CTX = (1, 8, 256), 784
PALI_VERIFY_CTX = [768, 800, 790, 769, 777, 783, 795, 0]
# the ISA program checked against the int-mode matmul: a 16 -> 16 channel
# 3x3 conv over 8 x 8, padding 1
ISA_LAYER = dict(cin=16, cout=16, k=3, h=8, w=8, stride=1, padding=1)
# phase 9, training: full llama3.2-3b at the JAX launcher's defaults (batch
# 8 x seq 512), TRAIN_STEPS steps; full mamba2-130m through Trainer, a run
# failing at MAMBA_FAIL_AT resumed from its checkpoint every MAMBA_CKPT_EVERY
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
# phase 10, the multi-device modules at world size 1 over NCCL: the mesh
# launcher's steps (held to the unsharded Trainer's loss and grad norm
# within MESH_TRAIN_RTOL), and compressed_grad_reduce card vs CPU within
# MESH_COLL_RTOL of the mean's largest magnitude
MESH_TRAIN_STEPS, MESH_TRAIN_RTOL, MESH_COLL_RTOL = 3, 1e-5, 1e-6
# phase 11, the tensor-parallel mapping at world size 1 over NCCL:
# mixtral-8x22b cut to TP_MOE_LAYERS layer(s) at full width, TP_MOE_STEPS
# steps at TP_MOE_BATCH x TRAIN_SEQ; zamba2-7b cut to TP_WAVE_LAYERS layers
# through Server(mesh=)
TP_MOE_LAYERS, TP_MOE_STEPS, TP_MOE_BATCH = 1, 2, 4
TP_WAVE_LAYERS = 7
# one rank's attention of llama3.2-3b on a 2-wide model axis: 4 of its 8 kv
# heads with their G = 3 query heads each, head dim 128 (phase 2's paged
# decode and prefill cases; the pools of ServeEngine(mesh=) hold these)
TP_KV_HEADS = (4, 3, 128)
# phase 14's one-shot-prefill families on the mesh: full paligemma-3b and
# musicgen-medium, TP_PREFIX_REQUESTS requests of TP_PREFIX_PROMPT tokens
# after their prefix embeddings, TP_PREFIX_NEW new, phase 8's (w, kv) cycles
# with every other request speculative (spec_k SPEC_K, a w4 draft)
TP_PREFIX_REQUESTS, TP_PREFIX_PROMPT, TP_PREFIX_NEW = 4, 256, 16
MAMBA_STEPS, MAMBA_CKPT_EVERY, MAMBA_FAIL_AT = 12, 4, 6
# phase 12, the dry run against the card at world size 1: phase 9's train
# step, and full llama3.2-3b's W4 / kv8 static-wave decode_step at
# DRYRUN_DECODE_ROWS rows (one rank's rows of decode_32k on the 16 x 16
# mesh) against a full cache of DRYRUN_DECODE_CTX; the argument bytes held
# within DRYRUN_ARG_RTOL of the card's, the peak within DRYRUN_PEAK_RTOL
DRYRUN_DECODE_ROWS, DRYRUN_DECODE_CTX = 8, 32768
# phase 13, the examples: train_lm's steps on the card (its default arch)
EXAMPLE_TRAIN_STEPS = 40
DRYRUN_ARG_RTOL, DRYRUN_PEAK_RTOL = 0.01, 0.10
# the numbers of a phase-2 case that the kernels line carries
LINE_KEYS = ("case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")


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


_T0 = time.perf_counter()


def emit(record: dict) -> None:
    """Print one JSON line, stamped with the seconds since the script began
    (``t_s``: where the smoke's time goes)."""
    print(json.dumps({**record, "t_s": round(time.perf_counter() - _T0, 1)}), flush=True)


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
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mpmm import launch_plan, mpmm_cost, mpmm_cuda
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
    def contract_case(args, kwargs, got):
        """Keep a case's shapes for phase 12's meta contract."""
        summary["mpmm_dequant"].setdefault("contract_cases", []).append(
            ([(tuple(t.shape), t.dtype) for t in args], kwargs, tuple(got.shape), got.dtype))

    def mpmm_case(x, wd, ws, w_bits, w_deq):
        m, k = x.shape
        n = wd.shape[-1]
        got = mpmm_cuda(x, wd, ws, w_bits=w_bits)
        contract_case((x, wd, ws), dict(w_bits=w_bits, out_dtype=torch.bfloat16), got)
        exp = ref.mpmm_ref(x, wd, ws, w_bits=w_bits)
        err = max_err(torch, got, exp, MPMM_TOL)
        del exp
        check(torch.equal(got, mpmm_cuda(x, wd, ws, w_bits=w_bits)),
              f"mpmm w{w_bits} M={m} K={k} N={n}: two runs gave other bits")
        flops, nbytes = mpmm_cost(m, k, n, wd.numel())
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
        for label, case in (("prefill", PREFILL_MPMM_CASE), ("verify", VERIFY_MPMM_CASE)):
            if (w_bits, m, k, n) == case:
                summary["mpmm_dequant"][label] = {key: rec[key] for key in LINE_KEYS}
        for label, case in EXPERT_MPMM_CASES.items():
            if (w_bits, m, k, n) == case:
                summary["mpmm_dequant"].setdefault("expert", {})[label] = {
                    key: rec[key] for key in LINE_KEYS}
        for label, (bk, bn) in TP_BLOCK_SHAPES.items():
            if (w_bits, k, n) == (8, bk, bn) and m in TP_BLOCK_M:
                summary["mpmm_dequant"].setdefault("tp_blocks", {})[f"{label} M={m}"] = {
                    key: rec[key] for key in LINE_KEYS}

    # a row-split partial under the TP mapping: the f32 entry, the scaled f32
    # sum uncast, held to mpmm_ref's within f32 summation-order error (the
    # products are exact in f32) and, cast to bf16, to the bf16 entry's bits
    def mpmm_f32_case(x, wd, ws, w_deq, label):
        m, k = x.shape
        n = wd.shape[-1]
        f32 = torch.float32
        got = mpmm_cuda(x, wd, ws, w_bits=8, out_dtype=f32)
        contract_case((x, wd, ws), dict(w_bits=8, out_dtype=f32), got)
        exp = ref.mpmm_ref(x, wd, ws, w_bits=8, out_dtype=f32)
        tol = dict(atol=k * 2.0**-22 * x.float().abs().max().item() * 127 * ws.max().item(),
                   rtol=1e-5)
        err = max_err(torch, got, exp, tol)
        del exp
        check(torch.equal(got.to(torch.bfloat16), mpmm_cuda(x, wd, ws, w_bits=8)),
              f"mpmm f32 entry M={m} K={k} N={n}: cast to bf16, not the bf16 entry's bits")
        check(torch.equal(got, mpmm_cuda(x, wd, ws, w_bits=8, out_dtype=f32)),
              f"mpmm f32 entry M={m} K={k} N={n}: two runs gave other bits")
        flops, nbytes = mpmm_cost(m, k, n, wd.numel(), out_bytes=4)
        b_ms, b_by = bound(nbytes, flops)
        rec = {
            "case": f"w8 f32 out M={m} K={k} N={n}", "max_abs_err": err, "tol": tol,
            "ms": timer(lambda: mpmm_cuda(x, wd, ws, w_bits=8, out_dtype=f32)),
            "plain_ms": timer(lambda: ref.mpmm_ref(x, wd, ws, w_bits=8, out_dtype=f32),
                              iters=3),
            "library_ms": timer(lambda: torch.mm(x, w_deq, out_dtype=f32)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        note("mpmm_dequant", rec, False)
        summary["mpmm_dequant"].setdefault("tp_partials", {})[f"{label} M={m}"] = {
            key: rec[key] for key in LINE_KEYS}

    def deq(wd, ws, w_bits):
        return ((unpack_int4(wd, 0) if w_bits == 4 else wd).float() * ws).to(torch.bfloat16)

    for shapes, ms in ((MPMM_SHAPES, (1, 2, 3, 4, 5, 8, VERIFY_M, 128, 256)),
                       (MIXTRAL_EXPERT_SHAPES, MIXTRAL_EXPERT_M)):
        for w_bits in (4, 8):
            for k, n in shapes:
                w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
                wd, ws = ops.pack_weights(w, w_bits)
                w_deq = deq(wd, ws, w_bits)
                del w
                for m in ms:
                    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                    mpmm_case(x, wd, ws, w_bits, w_deq)
                del wd, ws, w_deq
        torch.cuda.empty_cache()
    # one rank's blocks under the TP mapping (4-wide model axis), w8; the
    # row blocks also as row-split partials (the f32 entry)
    for label, (k, n) in TP_BLOCK_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        wd, ws = ops.pack_weights(w, 8)
        w_deq = deq(wd, ws, 8)
        del w
        for m in TP_BLOCK_M:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            mpmm_case(x, wd, ws, 8, w_deq)
            if label.endswith("rows"):
                mpmm_f32_case(x, wd, ws, w_deq, label)
        del wd, ws, w_deq
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

    paged_kernel_cases(torch, timer, gpu, summary)
    return summary


def paged_kernel_cases(torch, timer, gpu, summary, dtypes=("bf16", "f32")) -> None:
    """Phase 2's paged decode and paged prefill cases (``dtypes``: the bf16
    instantiations, the f32 ones or both) against their plain versions;
    each f32 case also prints its plan (splits, merge launches) and the
    registers / spills ptxas gave its instantiation."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import paged_prefill as pf_mod
    from repro_torch.kernels.paged_decode import decode_plan, paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import launch_grid, paged_mqa_prefill_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    prefill_plan = getattr(pf_mod, "prefill_plan", None)  # absent from older checkouts
    lib_path = _build.build()
    f32_regs = {"prefill": ptxas_report(lib_path, "paged_prefill_f32_kernelI",
                                        ("dp", "kv_bits", "row_warps")),
                "decode": ptxas_report(lib_path, "paged_decode_kernelIf", ("kv_bits", "nc"))}

    def note(name, rec, representative):
        note_case(summary, gpu, name, rec, representative)

    def ptxas_of(kind, **key):
        """ptxas registers / spill bytes of the f32 instantiation ``key``."""
        for e in f32_regs[kind]:
            if all(e.get(k) == v for k, v in key.items()):
                return {k: e.get(k) for k in ("registers", "spill_store_bytes")}
        return None

    # ---- paged attention inputs at llama3.2-3b's widths; the f32
    # instantiations (a float32 model) take f32 q, f32 16-bit pools and give
    # f32 out, held to F32_ATTN_TOL, their bound three bf16 passes of the
    # products (an f32-accurate product with integer K/V, as for the f32
    # matmul entries) beside one pass at the f32 FMA rate (bound_f32_ms),
    # and the error a q rounded to bf16 gives printed beside theirs
    hkv, g, d, ps, n_layers, layer = 8, 3, 128, 16, 2, 1
    h = hkv * g
    f32 = torch.float32

    def payload(shape, kv_bits, dtype=torch.bfloat16):
        """Random K or V in the pool's format: (payload, per-token scales)."""
        x = torch.randn(*shape, generator=gen, device="cuda")
        if kv_bits == 16:
            return x.to(dtype), None
        return ops.quantize_kv(x, kv_bits)

    def kv_bytes(tokens, kv_bits, heads=hkv, dim=d, itemsize=2):
        per_tok = heads * (dim // 2 if kv_bits == 4 else dim) * (itemsize if kv_bits == 16 else 1)
        return tokens * 2 * (per_tok + (heads * 4 if kv_bits < 16 else 0))

    def gathered(pool, scale, tables, kv_bits, new, new_scale, groups=g, dtype=torch.bfloat16):
        """[B, H, S, D] K or V for SDPA (``dtype``): the table's pages
        dequantized, then the new token(s) [B, T, Hkv, Dk], KV heads repeated
        to H."""
        sc = None if scale is None else ref.gather_pages(scale, tables)[layer]
        old = ref._dequant(ref.gather_pages(pool, tables)[layer], sc, kv_bits)
        full = torch.cat([old, ref._dequant(new, new_scale, kv_bits)], dim=1)
        return full.to(dtype).transpose(1, 2).repeat_interleave(groups, dim=1).contiguous()

    def touched(n, lo):
        """Table slots a row reads for live positions [lo, n)."""
        return -(-n // ps) - lo // ps if n > lo else 0

    def summary_line(name, line, rec):
        """A case the kernels line carries: the bf16 kernels' under its own
        key, the f32 instantiations' under "shapes"."""
        keys = LINE_KEYS + (("bound_f32_ms", "bf16_q_max_abs_err") if name.endswith("f32") else ())
        entry = {key: rec[key] for key in keys}
        if name.endswith("f32"):
            summary[name].setdefault("shapes", {})[line] = entry
        else:
            summary[name][line] = entry

    def costed(rec, dtype, nbytes, flops):
        """bound_ms / bound_by of a case; for f32, three bf16 passes of
        the products, and bound_f32_ms beside it."""
        if dtype == f32:
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * flops)
            rec["bound_f32_ms"] = bound(nbytes, flops, PEAK_F32_FLOPS)[0]
        else:
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        return rec

    # ---- paged decode: B = 8 at llama3.2-3b's heads, ctx in {0, 1, 17, 1024},
    # with and without a window; yi-9b's heads (4 x 8 x 128) at ctx 1024 (kv8,
    # kv4); gemma3-1b's (1 x 4 x 256) with its window of 1024 at ctx 2048 (kv8)
    def decode_cases(kv_bits, ctxs, windows, heads=(hkv, g, d), label="", line=None,
                     dtype=torch.bfloat16, table_end=False):
        """``line``: this call's kv8 case is the kernels line's ``line``
        entry; ``table_end``: the table holds exactly max(ctxs) positions,
        so a row of that length sits at its table's end."""
        hk, gq, dd = heads
        hh, b = hk * gq, 8
        name = "paged_decode_f32" if dtype == f32 else "paged_decode"
        tol = F32_ATTN_TOL if dtype == f32 else ATTN_TOL
        w = -(-max(ctxs) // ps) if table_end else -(-(max(ctxs) + 1) // ps)
        n_pages = b * w + 4
        kp, ks = payload((n_layers, n_pages, ps, hk, dd), kv_bits, dtype)
        vp, vs = payload((n_layers, n_pages, ps, hk, dd), kv_bits, dtype)
        tables = torch.randperm(n_pages, generator=gen, device="cuda")[: b * w]
        tables = tables.reshape(b, w).to(torch.int32)
        nk, nks = payload((b, hk, dd), kv_bits, dtype)
        nv, nvs = payload((b, hk, dd), kv_bits, dtype)
        q = torch.randn(b, hh, dd, generator=gen, device="cuda").to(dtype)
        qg = q.reshape(b, hk, gq, dd)
        for ctx in ctxs:
            lengths = torch.tensor([max(ctx - (i % 3), 0) for i in range(b)],
                                   dtype=torch.int32, device="cuda")
            for window in windows:
                args = (kp, vp, ks, vs, tables, lengths, layer, nk, nv, nks, nvs)
                sm = 1 / math.sqrt(dd)
                got = paged_mqa_decode_cuda(qg, *args, kv_bits=kv_bits, sm_scale=sm,
                                            window=window).reshape(b, hh, dd)
                exp = ref.paged_mqa_decode_ref(q, *args, sm_scale=sm, kv_bits=kv_bits,
                                               window=window)
                err = max_err(torch, got, exp, tol)
                check(got.dtype == dtype, f"{name}: output {got.dtype}, not {dtype}")
                lens = lengths.tolist()
                los = [max(n + 1 - window, 0) if window else 0 for n in lens]
                live = [n - lo if n > lo else 0 for n, lo in zip(lens, los)]
                slots = sum(touched(n, lo) for n, lo in zip(lens, los))
                nbytes = (2 * q.numel() * q.element_size()
                          + kv_bytes(sum(live) + b, kv_bits, hk, dd, q.element_size())
                          + 4 * (slots + b))
                # library yardstick: SDPA over gathered, dequantized K/V + new token
                one = lambda t: None if t is None else t[:, None]  # noqa: E731
                kg = gathered(kp, ks, tables, kv_bits, one(nk), one(nks), gq, dtype)
                vg = gathered(vp, vs, tables, kv_bits, one(nv), one(nvs), gq, dtype)
                pos = torch.arange(kg.shape[2], device="cuda")
                mask = (pos[None] < lengths[:, None]) | (pos[None] == kg.shape[2] - 1)
                if window:
                    mask &= pos[None] >= (lengths[:, None] + 1 - window)
                mask = mask[:, None, None, :]
                q4 = q[:, :, None, :]
                heads_s = f"{label} {hk}x{gq}x{dd} " if label else ""
                rec = costed({
                    "case": f"{'f32 ' if dtype == f32 else ''}{heads_s}kv{kv_bits} B={b} "
                            f"ctx={ctx} window={window}" + (" table end" if table_end else ""),
                    "max_abs_err": err, "tol": tol,
                    "ms": timer(lambda: paged_mqa_decode_cuda(
                        qg, *args, kv_bits=kv_bits, sm_scale=sm, window=window)),
                    "plain_ms": timer(lambda: ref.paged_mqa_decode_ref(
                        q, *args, sm_scale=sm, kv_bits=kv_bits, window=window), iters=3),
                    "library_ms": timer(lambda: F.scaled_dot_product_attention(
                        q4, kg, vg, attn_mask=mask)),
                }, dtype, nbytes, 4.0 * hh * dd * sum(n + 1 for n in live))
                if dtype == f32:  # the same kernel on q rounded to bf16: what it loses
                    rq = qg.to(torch.bfloat16).float()
                    rec["bf16_q_max_abs_err"] = (paged_mqa_decode_cuda(
                        rq, *args, kv_bits=kv_bits, sm_scale=sm, window=window
                    ).reshape(b, hh, dd) - exp).abs().max().item()
                    check(rec["max_abs_err"] * 10 <= rec["bf16_q_max_abs_err"]
                          or rec["bf16_q_max_abs_err"] == 0,  # ctx 0: the new token's V alone
                          f"{name} {rec['case']}: error {rec['max_abs_err']:.3g} not a tenth "
                          f"of a bf16 q's {rec['bf16_q_max_abs_err']:.3g}")
                    plan = decode_plan(b, hk, gq, dd, w, ps, window, kv_bits, 4)
                    rec["plan"] = {"splits": plan["splits"], "per_split": plan["per_split"],
                                   "block_warps": plan["block_warps"],
                                   "merge_launches": int(plan["splits"] > 1)}
                    rec["ptxas"] = ptxas_of("decode", kv_bits=kv_bits, nc=4 if dd <= 128 else 8)
                note(name, rec, (kv_bits, ctx, window, label, table_end)
                     == (8, 1024, None, "", False))
                if line and kv_bits == 8:
                    summary_line(name, line, rec)
        del kp, vp, ks, vs
        torch.cuda.empty_cache()

    bf16, f32_on = "bf16" in dtypes, "f32" in dtypes
    if bf16:
        for kv_bits in (4, 8, 16):
            decode_cases(kv_bits, (0, 1, 17, 1024), (None, 256))
        for kv_bits in (8, 4):
            decode_cases(kv_bits, (1024,), (None,), (4, 8, 128), "yi-9b heads")
        decode_cases(8, (2048,), (1024,), (1, 4, 256), "gemma3-1b heads")
        for kv_bits in (8, 4):
            decode_cases(kv_bits, (MUSIC_DECODE_CTX,), (None,), MUSIC_HEADS, "musicgen-medium heads",
                         "g1_d64")
        decode_cases(8, (PALI_DECODE_CTX,), (None,), PALI_HEADS, "paligemma-3b heads", "g8_d256")
        for kv_bits in (8, 4, 16):
            decode_cases(kv_bits, (1024,), (None,), TP_KV_HEADS, "llama3.2-3b one rank of 2 (TP)",
                         "tp_kv_heads")
    if f32_on:
        # the f32 instantiation: llama3.2-3b's heads (split and one-split rows,
        # with and without a window, a row at its table's end), gemma3-1b's
        # (head dim 256, its window) and paligemma-3b's (1 x 8 x 256)
        for kv_bits in (4, 8, 16):
            decode_cases(kv_bits, (0, 1, 17, 1024), (None, 256), dtype=f32)
            decode_cases(kv_bits, (1024,), (None,), label="llama3.2-3b", line="table_end",
                         dtype=f32, table_end=True)
            decode_cases(kv_bits, (2048,), (GEMMA_WINDOW,), GEMMA_HEADS, "gemma3-1b heads",
                         "g4_d256_window", f32)
            decode_cases(kv_bits, (PALI_DECODE_CTX,), (None,), PALI_HEADS, "paligemma-3b heads",
                         "g8_d256", f32)

    # ---- paged prefill: C in {1, 32, 128}, ragged q_lens, ctx > 0; then a
    # speculative verify window (C = SPEC_K + 1 at B = 8, VERIFY_CTX); then
    # gemma3-1b's heads (1 x 4 x 256) at ctx ~1536, C 128 and a verify
    # window, with and without its window of 1024, and D = 192 (padded to 256)
    def prefill_cases(kv_bits, ctx_list, chunks, label="", heads=(hkv, g, d), window=None,
                      line=None, dtype=torch.bfloat16):
        """``line`` = (key, C): that C's case at kv8 is the kernels line's
        ``key`` entry."""
        hk, gq, dd = heads
        hh = hk * gq
        b = len(ctx_list)
        name = "paged_prefill_f32" if dtype == f32 else "paged_prefill"
        tol = F32_ATTN_TOL if dtype == f32 else ATTN_TOL
        w = -(-(max(ctx_list) + max(c for c, _ in chunks)) // ps)
        n_pages = b * w + 4
        kp, ks = payload((n_layers, n_pages, ps, hk, dd), kv_bits, dtype)
        vp, vs = payload((n_layers, n_pages, ps, hk, dd), kv_bits, dtype)
        tables = torch.randperm(n_pages, generator=gen, device="cuda")[: b * w]
        tables = tables.reshape(b, w).to(torch.int32)
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
        for c, ql in chunks:
            q_lens = torch.tensor(ql, dtype=torch.int32, device="cuda")
            q = torch.randn(b, c, hh, dd, generator=gen, device="cuda").to(dtype)
            ck, cks = payload((b, c, hk, dd), kv_bits, dtype)
            cv, cvs = payload((b, c, hk, dd), kv_bits, dtype)
            qg = q.reshape(b, c, hk, gq, dd).permute(0, 2, 1, 3, 4).contiguous()

            def t(x):
                return None if x is None else x.transpose(1, 2).contiguous()

            kargs = (kp, vp, ks, vs, tables, ctx, q_lens, layer, t(ck), t(cv), t(cks), t(cvs))
            pargs = (kp, vp, ks, vs, tables, ctx, q_lens, layer, ck, cv, cks, cvs)
            sm = 1 / math.sqrt(dd)
            got = paged_mqa_prefill_cuda(qg, *kargs, kv_bits=kv_bits, sm_scale=sm,
                                         window=window)
            got = got.permute(0, 2, 1, 3, 4).reshape(b, c, hh, dd)
            exp = ref.paged_mqa_prefill_ref(q, *pargs, sm_scale=sm, kv_bits=kv_bits,
                                            window=window)
            err = max_err(torch, got, exp, tol)
            check(got.dtype == dtype, f"{name}: output {got.dtype}, not {dtype}")
            again = paged_mqa_prefill_cuda(qg, *kargs, kv_bits=kv_bits, sm_scale=sm,
                                           window=window)
            check(torch.equal(got, again.permute(0, 2, 1, 3, 4).reshape(b, c, hh, dd)),
                  f"{name} {label}kv{kv_bits} C={c}: two runs gave other bits")
            # what this run's data needs: each valid query sees its causal
            # keys inside the window; a row reads its keys from the first
            # query's window start on (query positions past q_len, and chunk
            # keys j >= q_len, are padding that nothing needs)
            def lo_of(n):
                return max(n + 1 - window, 0) if window else 0

            visible = sum(min(n + ci + 1, window or n + ci + 1)
                          for n, qn in zip(ctx_list, ql) for ci in range(qn))
            keys = sum(n - lo_of(n) + qn for n, qn in zip(ctx_list, ql) if qn)
            slots = sum(touched(n, lo_of(n)) for n, qn in zip(ctx_list, ql) if qn)
            nbytes = (2 * q.numel() * q.element_size()
                      + kv_bytes(keys, kv_bits, hk, dd, q.element_size()) + 4 * (slots + 2 * b))
            kg = gathered(kp, ks, tables, kv_bits, ck, cks, gq, dtype)
            vg = gathered(vp, vs, tables, kv_bits, cv, cvs, gq, dtype)
            s_len = w * ps
            kpos = torch.cat([torch.arange(s_len, device="cuda").expand(b, s_len),
                              ctx[:, None] + torch.arange(c, device="cuda")[None]], 1)
            kval = torch.cat([torch.arange(s_len, device="cuda")[None] < ctx[:, None],
                              torch.arange(c, device="cuda")[None] < q_lens[:, None]], 1)
            qpos = ctx[:, None] + torch.arange(c, device="cuda")[None]
            mask = kval[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
            if window:
                mask &= kpos[:, None, :] > qpos[:, :, None] - window
            mask = mask[:, None]
            qt = q.transpose(1, 2)
            heads_s = "" if heads == (hkv, g, d) else f"{hk}x{gq}x{dd} "
            rec = costed({
                "case": f"{'f32 ' if dtype == f32 else ''}{label}{heads_s}kv{kv_bits} B={b} "
                        f"C={c} ctx={ctx_list} q_lens={ql}"
                        + (f" window={window}" if window else ""),
                "max_abs_err": err, "tol": tol, "grid": launch_grid(b, hk, c, gq),
                "ms": timer(lambda: paged_mqa_prefill_cuda(
                    qg, *kargs, kv_bits=kv_bits, sm_scale=sm, window=window)),
                "plain_ms": timer(lambda: ref.paged_mqa_prefill_ref(
                    q, *pargs, sm_scale=sm, kv_bits=kv_bits, window=window), iters=3),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask)),
            }, dtype, nbytes, 4.0 * hh * dd * visible)
            if dtype == f32:  # the same kernel on q rounded to bf16: what it loses
                rq = qg.to(torch.bfloat16).float()
                rec["bf16_q_max_abs_err"] = (paged_mqa_prefill_cuda(
                    rq, *kargs, kv_bits=kv_bits, sm_scale=sm, window=window
                ).permute(0, 2, 1, 3, 4).reshape(b, c, hh, dd) - exp).abs().max().item()
                check(rec["max_abs_err"] * 10 <= rec["bf16_q_max_abs_err"],
                      f"{name} {rec['case']}: error {rec['max_abs_err']:.3g} not a tenth "
                      f"of a bf16 q's {rec['bf16_q_max_abs_err']:.3g}")
                if prefill_plan is not None:
                    plan = prefill_plan(b, hk, c, gq, dd, w, ps, window, kv_bits, 4)
                    rec["grid"] = plan["grid"]
                    rec["plan"] = {**{k: plan[k] for k in ("rows_per_block", "key_warps",
                                                            "keys_per_tile", "splits")},
                                   "merge_launches": int(plan["splits"] > 1)}
                    rec["ptxas"] = ptxas_of("prefill", dp=pf_mod.padded_head_dim(dd),
                                            kv_bits=kv_bits, row_warps=plan["row_warps"])
            note(name, rec, (kv_bits, c, label) == (8, 128, ""))
            if line and kv_bits == 8 and c == line[1]:
                summary_line(name, line[0], rec)
        del kp, vp, ks, vs

    if bf16:
        for kv_bits in (4, 8, 16):
            prefill_cases(kv_bits, [256, 200, 384, 128],
                          [(c, [c, max(c - 1, 1), max(c // 2, 1), 1]) for c in (1, 32, 128)])
        for kv_bits in (8, 4, 16):
            prefill_cases(kv_bits, VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)], "verify ",
                          line=("verify", SPEC_K + 1))
        for kv_bits in (8, 4, 16):
            for window in (GEMMA_WINDOW, None):
                line = ("d256", 128) if window else None
                prefill_cases(kv_bits, GEMMA_PREFILL_CTX, [(128, GEMMA_PREFILL_Q_LENS)],
                              "gemma3-1b ", GEMMA_HEADS, window, line)
                prefill_cases(kv_bits, GEMMA_VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)],
                              "gemma3-1b verify ", GEMMA_HEADS, window)
        prefill_cases(8, GEMMA_PREFILL_CTX, [(128, GEMMA_PREFILL_Q_LENS)], "D=192 (pads to 256) ",
                      (1, 4, 192), GEMMA_WINDOW)
        for kv_bits in (8, 4, 16):
            prefill_cases(kv_bits, PALI_VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)],
                          "paligemma-3b verify ", PALI_HEADS, line=("paligemma_verify", SPEC_K + 1))
        # one rank's kv heads under the TP mapping: a 128-token chunk and a
        # verify window
        for kv_bits in (8, 4, 16):
            prefill_cases(kv_bits, [256, 200, 384, 128], [(128, [128, 127, 64, 1])],
                          "llama3.2-3b one rank of 2 (TP) ", TP_KV_HEADS,
                          line=("tp_kv_heads", 128))
            prefill_cases(kv_bits, VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)],
                          "llama3.2-3b one rank of 2 (TP) verify ", TP_KV_HEADS,
                          line=("tp_kv_heads_verify", SPEC_K + 1))
    if f32_on:
        # the f32 instantiation: llama3.2-3b's heads at C 1, 5 (a verify
        # window) and 128; gemma3-1b's at C 128 with its window and at a verify
        # window, D = 192 (padded to 256); paligemma-3b's verify window
        for kv_bits in (4, 8, 16):
            prefill_cases(kv_bits, [256, 200, 384, 128],
                          [(c, [c, max(c - 1, 1), max(c // 2, 1), 1]) for c in (1, 128)],
                          dtype=f32)
            prefill_cases(kv_bits, VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)], "verify ",
                          line=("verify", SPEC_K + 1), dtype=f32)
            prefill_cases(kv_bits, GEMMA_PREFILL_CTX, [(128, GEMMA_PREFILL_Q_LENS)], "gemma3-1b ",
                          GEMMA_HEADS, GEMMA_WINDOW, ("d256", 128), f32)
            prefill_cases(kv_bits, GEMMA_VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)],
                          "gemma3-1b verify ", GEMMA_HEADS, GEMMA_WINDOW, dtype=f32)
            prefill_cases(kv_bits, GEMMA_PREFILL_CTX, [(128, GEMMA_PREFILL_Q_LENS)],
                          "D=192 (pads to 256) ", (1, 4, 192), GEMMA_WINDOW, dtype=f32)
            prefill_cases(kv_bits, PALI_VERIFY_CTX, [(SPEC_K + 1, VERIFY_Q_LENS)],
                          "paligemma-3b verify ", PALI_HEADS, line=("paligemma_verify", SPEC_K + 1),
                          dtype=f32)
    torch.cuda.empty_cache()


def note_case(summary, gpu, name, rec, representative) -> None:
    """Print one phase-2 case; keep the kernel's largest error (and, for the
    f32 instantiations, the largest a q rounded to bf16 gives) and, from its
    representative case, the numbers of the kernels line."""
    summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], rec["max_abs_err"])
    if "bf16_q_max_abs_err" in rec:
        summary[name]["bf16_q_max_abs_err"] = max(summary[name].get("bf16_q_max_abs_err", 0.0),
                                                  rec["bf16_q_max_abs_err"])
    if representative:
        summary[name].update({k: rec[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "case",
            *(("bound_f32_ms",) if "bound_f32_ms" in rec else ()))})
    emit({"phase": "kernels", "kernel": name, **rec, "gpu": gpu})


def near_cdf_boundary(torch, logits, temps, top_k, top_p, u, eps=1e-6):
    """[B] bool: rows whose uniform lies within ``eps`` of a boundary of the
    sampled distribution's CDF (float64, on the CPU), where an f32 sum in
    another order may pick the neighbouring token."""
    from repro_torch.kernels import ops

    probs = ops.sampling_probs(logits, temps, top_k, top_p).double()
    cdf = torch.cumsum(probs / probs.sum(-1, keepdim=True), dim=-1)
    return ((cdf - u.double()[:, None]).abs() < eps).any(dim=-1)


def sampler_case(torch, timer, gpu) -> dict:
    """``ops.sample_tokens`` (plain torch ops: the port's threefry, the
    top-k/top-p mask and the blocked inverse CDF) on the card against the
    same function on the CPU, on identical f32 logits at llama3.2-3b's
    vocabulary: B = 8, temperature 0.8, top_k 50, top_p 0.95.  Keys and
    uniforms must be bit-equal, and the tokens equal on every row whose
    uniform lies farther than 1e-6 from a CDF boundary.  Timed beside a
    temperature-only draw (no vocabulary sort) and the greedy argmax."""
    from repro_torch.kernels import ops, prng

    gen = torch.Generator().manual_seed(5)
    b, v = 8, 128256
    logits = torch.randn(b, v, generator=gen) * 3
    seeds = torch.arange(b, dtype=torch.int64)
    pos = torch.arange(600, 600 + b, dtype=torch.int64)
    temps, top_k, top_p = torch.full((b,), 0.8), torch.full((b,), 50), torch.full((b,), 0.95)
    keys = ops.sample_keys(seeds, pos)
    card = [t.cuda() for t in (logits, temps, top_k, top_p)]
    keys_card = ops.sample_keys(seeds.cuda(), pos.cuda())
    check(torch.equal(keys_card.cpu(), keys), "sample_keys: card and CPU keys differ")
    u = prng.uniform(keys)
    check(torch.equal(prng.uniform(keys_card).cpu(), u), "uniform: card and CPU differ")
    want = ops.sample_tokens(logits, keys, temps, top_k, top_p)
    got = ops.sample_tokens(card[0], keys_card, *card[1:]).cpu()
    near = near_cdf_boundary(torch, logits, temps, top_k, top_p, u)
    differ = got != want
    check(not bool((differ & ~near).any()),
          f"sample_tokens: card {got.tolist()} against CPU {want.tolist()} away from a "
          "CDF boundary")
    check(bool((got < v).all()), "sample_tokens drew outside the vocabulary")
    rec = {"phase": "sampler", "case": f"B={b} V={v} temperature 0.8 top_k 50 top_p 0.95",
           "tokens_equal": f"{b - int(differ.sum())}/{b}",
           "rows_near_cdf_boundary": int(near.sum()),
           "ms": timer(lambda: ops.sample_tokens(card[0], keys_card, *card[1:])),
           "temperature_only_ms": timer(lambda: ops.sample_tokens(card[0], keys_card, card[1])),
           "greedy_argmax_ms": timer(lambda: torch.argmax(card[0], dim=-1)),
           "cpu_ms": host_ms(lambda: ops.sample_tokens(logits, keys, temps, top_k, top_p)),
           "gpu": gpu}
    emit(rec)
    return rec


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
    from repro_torch.kernels.mpmm import (int_launch_plan, launch_plan, mpmm_cost, mpmm_cuda,
                                          mpmm_ff_cuda, mpmm_int_cuda)
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
        flops, nbytes = mpmm_cost(m, k, n, wd.numel(), out_bytes=4, scale=False)
        b_ms, b_by = bound(nbytes, flops)
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
        summary["mpmm_dequant"]["contract_cases"].append(
            ([(tuple(t.shape), t.dtype) for t in (x, wd, ws)],
             dict(w_bits=8, out_dtype=torch.bfloat16), tuple(got.shape), got.dtype))
        err = max_err(torch, got, ref.mpmm_ref(x, wd, ws, w_bits=8), MPMM_TOL)
        w_deq = dequantized(wd, ws, 8)
        flops, nbytes = mpmm_cost(m, k, n, wd.numel())
        b_ms, b_by = bound(nbytes, flops)
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


def x32_tol(k: int, x, ws=None) -> dict:
    """An f32-activation kernel against its plain version: the kernel
    multiplies the exact integer weights by x's two TF32 terms (hi + lo = x
    to within 2^-22 |x|), so each product is within 2^-22 |x| * 127 of the
    f32 product, and the sums run in another order: at most about K such
    steps of the largest |x| * 127 (times the largest scale where the output
    is scaled)."""
    scale = 1.0 if ws is None else ws.max().item()
    return dict(atol=k * 2.0**-22 * x.abs().max().item() * 127 * scale, rtol=1e-5)


def x32_kernel_cases(torch, timer, gpu, summary) -> None:
    """Phase 2 for the f32-activation entries (``mpmm_dequant_x32``,
    ``mpmm_ff_dequant_x32``: the CNN path and the quickstart in float32):
    the CF order at ResNet18's CF layers and at rows 3a / 3b's serving
    shapes, the FF order at ResNet18's FF layers (batch 8), w8 and (where K
    is even) w4.  Each against its plain version on the card (cuBLAS in
    full f32, TF32 off), twice for the same bits, its time beside the
    plain version's, the library's (``torch.mm`` in f32 on weights
    dequantized beforehand) and three bounds: the card's least time for an
    f32-accurate product, three bf16 terms of x times the weights (3 x 2MNK
    at the bf16 tensor-core rate, ``bound_ms``); this kernel's own work, two
    TF32 terms (2 x 2MNK at the TF32 rate, ``bound_tf32_ms``); and one pass
    at the card's f32 rate outside the tensor cores (``bound_f32_ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mpmm import (mpmm_cost, mpmm_cuda, mpmm_ff_cuda,
                                          x32_launch_plan)
    from repro_torch.kernels import ops
    from repro_torch.models.cnn_zoo import resnet18_layers
    from repro_torch.quant.pack import unpack_int4

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on: the f32 "
          "plain version and library call would not compute in full f32")
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = {l.name: l for l in resnet18_layers()}
    b = 8

    def case(name, label, x, wd, ws, w_bits, ff, representative):
        m, k = x.shape
        n = wd.shape[-1]
        if ff:
            def kern():
                return mpmm_ff_cuda(x, wd, w_bits=w_bits)

            def plain():
                return ref.mpmm_ff_ref(x, wd, w_bits=w_bits)
            tol = x32_tol(k, x)
        else:
            def kern():
                return mpmm_cuda(x, wd, ws, w_bits=w_bits)

            def plain():
                return ref.mpmm_ref(x, wd, ws, w_bits=w_bits)
            tol = x32_tol(k, x, ws)
        got = kern()
        check(got.dtype == torch.float32, f"{label}: the f32 entry wrote {got.dtype}")
        if not ff:  # phase 12 holds the CF entry's meta contract to it
            summary[name].setdefault("contract_cases", []).append(
                ([(tuple(t.shape), t.dtype) for t in (x, wd, ws)],
                 dict(w_bits=w_bits, out_dtype=torch.float32), tuple(got.shape), got.dtype))
        err = max_err(torch, got, plain(), tol)
        check(torch.equal(got, kern()), f"{label}: two runs gave other bits")
        w_deq = (unpack_int4(wd, 0) if w_bits == 4 else wd).float()
        if not ff:
            w_deq = w_deq * ws
        flops, nbytes = mpmm_cost(m, k, n, wd.numel(), x_bytes=4, out_bytes=4, scale=not ff)
        b_ms, b_by = bound(nbytes, 3 * flops, PEAK_FLOPS)
        tf32_ms, tf32_by = bound(nbytes, 2 * flops, PEAK_TF32_FLOPS)
        f32_ms, f32_by = bound(nbytes, flops, PEAK_F32_FLOPS)
        plan = x32_launch_plan(m, n, k, stage_k=ref.FF_STAGE_K if ff else None,
                               w_bits=w_bits)
        rec = {
            "case": f"{label} w{w_bits} f32 x M={m} K={k} N={n}", "max_abs_err": err,
            "tol": tol,
            "kernel_plan": {key: plan[key] for key in ("block_m", "splits", "grid")},
            "ms": timer(kern), "plain_ms": timer(plain, iters=3),
            "library_ms": timer(lambda: torch.mm(x, w_deq)),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tf32_ms": tf32_ms, "bound_tf32_by": tf32_by,
            "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
        }
        rec["tflops"] = flops / rec["ms"] / 1e9
        note_case(summary, gpu, name, rec, representative)
        return rec

    def layer_x(layer):
        img = torch.randn(b, layer.h, layer.w, layer.cin, generator=gen, device="cuda")
        x = ref.conv_patches(img, layer.k, layer.stride, layer.padding)
        return x.reshape(-1, x.shape[-1]).contiguous()

    for name, ff, layer_names in (("mpmm_ff_dequant_x32", True, FF_LAYERS),
                                  ("mpmm_dequant_x32", False, CF_LAYERS)):
        for lname in layer_names:
            x = layer_x(table[lname])
            w = torch.randn(x.shape[1], table[lname].cout, generator=gen, device="cuda")
            for w_bits in (8, 4):
                if w_bits == 4 and x.shape[1] % 2:
                    continue  # int4 packs K in pairs (conv1: K = 147)
                wd, ws = ops.pack_weights(w / math.sqrt(x.shape[1]), w_bits)
                rep = (lname, w_bits) in (("layer3.1.conv1", 8), ("layer3.0.down", 8))
                case(name, lname, x, wd, ws, w_bits, ff, rep)
            del x, w
    for label, (w_bits, m, k, n) in X32_SERVING_CASES.items():
        wd, ws = ops.pack_weights(torch.randn(k, n, generator=gen, device="cuda")
                                  / math.sqrt(k), w_bits)
        x = torch.randn(m, k, generator=gen, device="cuda")
        rec = case("mpmm_dequant_x32", f"serving {label}", x, wd, ws, w_bits, False, False)
        summary["mpmm_dequant_x32"].setdefault("serving", {})[label] = {
            key: rec[key] for key in LINE_KEYS}
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 3
def step_card_vs_cpu(torch, gpu, base, layers: int = 2, q_start=(0, 40), c: int = 32,
                     what: str = "step", witness_all: bool = False) -> None:
    """One prefill chunk (2 rows of ``c`` tokens at contexts ``q_start``)
    and one decode step of ``base`` cut to ``layers`` layers, on the card
    and on the CPU, for three (w_bits, kv_bits) pairs.

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
    Each such row is reported with the three picks and the gap.
    ``witness_all`` takes float32 as the witness at every kv_bits, but at
    int8 and 16-bit KV only on rows where float32's own top two logits lie
    within the row's bf16 noise (among gemma3-1b's 262144 random logits they
    may lie closer than one bf16 step, so two correct bf16 runs may pick
    either); every other row must pick alike.  It adds a second witness: the
    same step on the card with both paged attention kernels swapped for
    their plain versions, which must lie within twice the bf16 noise of the
    kernels' run and, on every split row with int8 or 16-bit KV, pick the
    kernels' token: the split is then not the attention kernels' doing.
    The same step runs on the card in float32 too (the f32 instantiations
    of the paged kernels, the f32-activation matmul), held to the CPU's
    float32 run by compare_logits_f32."""
    from repro_torch.models import transformer as model_lib
    from repro_torch.serve import decode, prefill

    arch, depth = base.name, base.n_layers
    base = dataclasses.replace(base, n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params16 = model_lib.init_params(base, gen)
    ps, b = 16, 2
    w = max(8, -(-(max(q_start) + c + 1) // ps))  # table width, pages a row
    n_pages = b * w + 8
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
        tables = torch.arange(b * w, dtype=torch.int32, device="cuda").reshape(b, w) + 3
        tokens = torch.randint(0, cfg.vocab, (b, c), generator=gen, device="cuda")
        next_tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device="cuda")
        starts = torch.tensor(q_start, dtype=torch.int32, device="cuda")
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
                p, to(tokens), to(starts), to(q_lens), to(tables), *pl, cfg=run_cfg)
            logits_d, _ = decode.paged_decode_step(
                p, to(next_tokens), to(starts + q_lens), to(tables), to(valid), *pl,
                cfg=run_cfg)
            return logits_p.cpu()[:, : cfg.vocab], logits_d.cpu()[:, : cfg.vocab]

        t0 = time.perf_counter()
        on_card = run("cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = run("cpu")
        t_cpu = time.perf_counter() - t0
        cpu32 = run("cpu", wide=True)
        t0 = time.perf_counter()
        card32 = run("cuda", wide=True)
        t_card32 = time.perf_counter() - t0
        plain = (None, None)
        if witness_all:
            with plain_paged_attention():
                plain = run("cuda")
        rec = {"phase": what, "model": f"{arch} ({layers} of {depth} layers, full width)",
               "w_bits": w_bits, "kv_bits": kv_bits, "batch": b, "chunk": c,
               "q_start": list(q_start), "card_s": t_card, "cpu_s": t_cpu,
               "card_f32_s": t_card32, "gpu": gpu}
        for i, name in enumerate(("prefill", "decode")):
            compare_logits(torch, rec, name, f"{arch} {name} w{w_bits}kv{kv_bits}",
                           on_card[i], cpu[i], cpu32[i], kv_bits, witness_all, plain[i])
            compare_logits_f32(torch, rec, name, f"{arch} {name} w{w_bits}kv{kv_bits}",
                               card32[i], cpu32[i], cpu[i])
        emit(rec)
        del params
    del params16


def compare_logits(torch, rec, name, tag, a, e, f, kv_bits, witness_all=False,
                   plain=None) -> None:
    """Card logits ``a`` against the CPU's bf16 ``e`` and float32 ``f`` runs
    of the same step (the rule of phase 3, described there): within twice
    the CPU's bf16 noise, the same argmax on every row with int8 or 16-bit
    KV, and with int4 KV (or, ``witness_all``, on near-tied rows at any KV)
    float32 as the witness where card and CPU split; ``plain`` is the card
    run with plain paged attention, the second witness of ``witness_all``."""
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
    if kv_bits >= 8 and not witness_all:
        check(agree == b, f"{tag}: argmax differs between card and CPU")
        return
    if plain is not None:
        plain_diff = (a - plain).abs()
        rec.update({f"{name}_vs_plain_attention_max_abs_err": plain_diff.max().item(),
                    f"{name}_vs_plain_attention_mean_abs_err": plain_diff.mean().item(),
                    f"{name}_plain_attention_argmax_agree":
                        f"{int((a_top == plain.argmax(-1)).sum())}/{b}"})
        check(plain_diff.max() <= 2 * noise.max() and plain_diff.mean() <= 2 * noise.mean(),
              f"{tag}: the card's runs with kernel and with plain attention differ by max "
              f"{plain_diff.max().item():.4g} / mean {plain_diff.mean().item():.4g}, over "
              f"twice the bf16 noise")
    f_two = f.topk(2, dim=-1).values
    split = []
    for r in torch.nonzero(a_top != e_top).flatten().tolist():
        ta, te, tf = int(a_top[r]), int(e_top[r]), int(f_top[r])
        gap = (f[r, tf] - torch.minimum(f[r, ta], f[r, te])).item()
        top2_gap = (f_two[r, 0] - f_two[r, 1]).item()
        row_noise = noise[r].max().item()
        row = {"row": r, "card": ta, "cpu_bf16": te, "cpu_f32": tf, "f32_gap": gap,
               "f32_top2_gap": top2_gap, "row_bf16_noise": row_noise}
        if plain is not None:
            row["card_plain_attention"] = int(plain[r].argmax())
        split.append(row)
        check(tf in (ta, te) or gap <= row_noise,
              f"{tag} row {r}: card picks {ta}, CPU bf16 {te}, float32 {tf}; "
              f"the picks lie {gap:.4g} below float32's top, over the row's "
              f"bf16 noise {row_noise:.4g}")
        if kv_bits >= 8:
            check(top2_gap <= row_noise,
                  f"{tag} row {r}: card picks {ta}, CPU {te}, though float32's top two "
                  f"lie {top2_gap:.4g} apart, over the row's bf16 noise {row_noise:.4g}")
            if plain is not None:
                check(row["card_plain_attention"] == ta,
                      f"{tag} row {r}: with plain attention the card picks "
                      f"{row['card_plain_attention']}, with the kernels {ta}")
    rec[f"{name}_argmax_splits"] = split


def compare_logits_f32(torch, rec, name, tag, a32, f, e) -> None:
    """The card's float32 logits ``a32`` against the CPU's float32 ``f``
    run of the same step (``e``: the CPU's bf16 run, whose distance to
    ``f`` is the bf16 noise): max and mean |a32 - f| within F32_LOGIT_RULE
    x the noise's max and mean, ten times tighter than compare_logits'
    bound, and the same argmax on every row whose float32 top-two gap
    exceeds F32_LOGIT_RULE x the largest noise."""
    b = a32.shape[0]
    check(bool(torch.isfinite(a32).all()), f"{tag} f32: non-finite logits")
    diff, noise = (a32 - f).abs(), (f - e).abs()
    tol_max, tol_mean = F32_LOGIT_RULE * noise.max(), F32_LOGIT_RULE * noise.mean()
    f_two = f.topk(2, dim=-1).values
    wide_gap = (f_two[:, 0] - f_two[:, 1]) > tol_max
    same = a32.argmax(-1) == f.argmax(-1)
    rec.update({f"{name}_f32_max_abs_err": diff.max().item(),
                f"{name}_f32_mean_abs_err": diff.mean().item(),
                f"{name}_f32_tol_max": tol_max.item(), f"{name}_f32_tol_mean": tol_mean.item(),
                f"{name}_f32_argmax_agree": f"{int(same.sum())}/{b}",
                f"{name}_f32_rows_past_tol_gap": int(wide_gap.sum())})
    check(diff.max() <= tol_max and diff.mean() <= tol_mean,
          f"{tag}: card vs CPU float32 logits differ by max {diff.max().item():.4g} / mean "
          f"{diff.mean().item():.4g}, over {F32_LOGIT_RULE} x the bf16 noise "
          f"{noise.max().item():.4g} / {noise.mean().item():.4g}")
    check(bool(same[wide_gap].all()),
          f"{tag}: float32 argmax differs between card and CPU on rows "
          f"{torch.nonzero(wide_gap & ~same).flatten().tolist()}, whose top two lie "
          f"more than {tol_max.item():.4g} apart")


@contextlib.contextmanager
def plain_paged_attention():
    """Within the block, ``ops.paged_mqa_prefill`` and ``ops.paged_mqa_decode``
    take their plain versions on the card too (a witness, not a path)."""
    from repro_torch.kernels import ops, ref

    saved = ops.paged_mqa_prefill, ops.paged_mqa_decode

    def plain(fn):
        def call(q, *args, kv_bits=8, window=None):
            return fn(q, *args, sm_scale=1.0 / math.sqrt(q.shape[-1]), kv_bits=kv_bits,
                      window=window)
        return call

    ops.paged_mqa_prefill = plain(ref.paged_mqa_prefill_ref)
    ops.paged_mqa_decode = plain(ref.paged_mqa_decode_ref)
    try:
        yield
    finally:
        ops.paged_mqa_prefill, ops.paged_mqa_decode = saved


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree) if hasattr(tree, "to") else tree


def mqa_kernel_cases(torch, timer, gpu, summary) -> None:
    """Phase 2 for contiguous-cache decode (csrc/mqa_decode.cu) against its
    plain version, with SDPA on the dequantized bf16 K/V as the yardstick;
    paligemma-3b's head dim 256 runs the wide instantiation."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mqa_decode import decode_cost, decode_plan, mqa_decode_cuda
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
        summary["mqa_decode"].setdefault("contract_cases", []).append(
            ([(tuple(t.shape), t.dtype) for t in (qg, kd, vd, ks, vs, lens)],
             dict(kv_bits=kv_bits, sm_scale=sm), tuple(got.shape), got.dtype))
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
        flops, nbytes = decode_cost(b, hkv, g, d, live, kv_bits)
        b_ms, b_by = bound(nbytes, flops)
        rec = {
            "case": f"{label} kv{kv_bits} B={b} S={s} Hkv={hkv} G={g} D={d} "
                    f"lengths={min(lengths)}-{max(lengths)}",
            "max_abs_err": err, "tol": ATTN_TOL, "plan": decode_plan(b, hkv, g, s, d),
            "ms": timer(lambda: mqa_decode_cuda(qg, kd, vd, ks, vs, lens, kv_bits=kv_bits,
                                                sm_scale=sm)),
            "plain_ms": timer(plain, iters=3),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(q4, kg, vg,
                                                                       attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        note_case(summary, gpu, "mqa_decode", rec,
                  (label, kv_bits) == ("zamba2 serving", 8))
        if label.startswith("zamba2 TP"):
            summary["mqa_decode"]["tp_heads"] = {key: rec[key] for key in LINE_KEYS}
        if label.startswith("paligemma-3b"):
            summary["mqa_decode"]["paligemma_heads"] = {key: rec[key] for key in LINE_KEYS}
        del kd, vd, ks, vs, kg, vg
    torch.cuda.empty_cache()


def hybrid_step_card_vs_cpu(torch, gpu, base) -> None:
    """zamba2-7b cut to 7 layers at full width (one group of 6 SSM layers,
    the shared attention block, a 1-layer tail), w8/kv8: prefill of 2 x 64
    tokens and two decode steps on the card and on the CPU (bf16 and
    float32), held by compare_logits (the rule of phase 3); the card's
    float32 run of the same steps by compare_logits_f32."""
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
    t0 = time.perf_counter()
    card32 = run("cuda", "float32")
    t_card32 = time.perf_counter() - t0
    rec = {"phase": "step_hybrid", "model": "zamba2-7b (7 of 81 layers, full width)",
           "w_bits": cfg.serve_w_bits, "kv_bits": cfg.serve_kv_bits, "batch": 2,
           "prompt": 64, "decode_steps": 2, "card_s": t_card, "cpu_s": t_cpu,
           "card_f32_s": t_card32, "gpu": gpu}
    for i, name in enumerate(("prefill", "decode1", "decode2")):
        compare_logits(torch, rec, name, f"zamba2 {name}", on_card[i], cpu[i], cpu32[i],
                       cfg.serve_kv_bits)
        compare_logits_f32(torch, rec, name, f"zamba2 {name}", card32[i], cpu32[i], cpu[i])
    emit(rec)
    del params


# --------------------------------------------------------------- waves
def waves_run(torch, seed: int, cfg, requests: int, prompt: int, new: int,
              capture: bool = True, mesh=None):
    """Serve ``requests`` greedy requests of ``prompt`` random tokens and
    ``new`` new tokens through the static-wave Server (batch 8, the arch's
    w/kv bits; ``Server(mesh=)`` with a mesh), with weights drawn from
    ``seed``, its decode step captured (or eager: ``capture=False``);
    returns (streams, stats, peak bytes, wall s, server)."""
    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.train.server import Request, Server

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    srv = Server(cfg, params, batch_size=8, max_len=prompt + new + 8, device="cuda", mesh=mesh)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt).astype(np.int32),
                    max_new_tokens=new) for i in range(requests)]
    t0 = time.perf_counter()
    with capturing(capture):
        srv.serve(reqs)
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.done and len(r.out_tokens) == new, f"request {r.rid}: {len(r.out_tokens)} "
              f"tokens, expected {new}")
        check(all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: token outside the vocabulary (padded logits leaked)")
    return [tuple(r.out_tokens) for r in reqs], srv.stats, torch.cuda.max_memory_allocated(), \
        wall, srv


def waves_profile(torch, srv, cfg, prompt: int, capture: bool = True) -> dict:
    """Two decode steps of a full wave (8 x ``prompt`` tokens prefilled)
    through the Server's decode step, captured (or eager), under
    torch.profiler: device time by kernel and the card's busy share of the
    unprofiled wall time of two steps (see :func:`step_profile`)."""
    tokens = torch.randint(0, cfg.vocab, (8, prompt), device="cuda")
    with capturing(capture):
        tok, _ = srv.prefill_wave({"tokens": tokens})

    def two_steps():
        nonlocal tok
        with capturing(capture):
            for _ in range(2):
                tok = srv.decode_wave(tok)
        torch.cuda.synchronize()

    two_steps()  # warm (and capture, the first time)
    t0 = time.perf_counter()
    two_steps()
    wall = time.perf_counter() - t0
    return step_profile(torch, two_steps, wall, srv.graphs, "wave_decode", capture, replays=2,
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


def device_profile(torch, run_once, wall_s: float, sums=None, top_ops: int = 0) -> dict:
    """One network run under torch.profiler: device time by kernel (the
    events that ran on the card; a host op's device time would count its
    kernels twice), and the share of the unprofiled wall time ``wall_s`` the
    card was busy (the profiler slows the host, so its own wall time is not
    used for the share).  ``sums`` maps a label to a test of a kernel's full
    name: the device ms and launches of the kernels it picks.  ``top_ops``:
    that many host ops with the most device time of their own (aten::mul,
    aten::copy_, ...), where the kernel names say little."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
    by_kernel = {}
    picked = {label: {"device_ms": 0.0, "launches": 0} for label in (sums or {})}
    graph_launches = 0
    for e in prof.key_averages():
        if e.key == "cudaGraphLaunch":
            graph_launches += e.count
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.key[:60]] = by_kernel.get(e.key[:60], 0.0) + e.device_time_total
            for label, test in (sums or {}).items():
                if test(e.key):
                    picked[label]["device_ms"] += e.device_time_total / 1e3
                    picked[label]["launches"] += e.count
    busy_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
           "device_busy_share": busy_ms / (wall_s * 1e3), "graph_launches": graph_launches,
           "top_kernels_us": {k: v for k, v in top}, **picked}
    if top_ops:
        ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
        out["top_ops"] = [{"op": k, "device_ms": ms, "calls": n}
                          for k, ms, n in sorted(ops, key=lambda r: -r[1])[:top_ops]]
    return out


def capturing(capture: bool):
    """The serving steps captured (the default) or eager
    (``graphs.disable_capture()``)."""
    import contextlib

    from repro_torch.serve import graphs

    return contextlib.nullcontext() if capture else graphs.disable_capture()


def last_captured(step_graphs, step: str):
    """The last graph a StepGraphs captured for ``step``."""
    return [g for key, g in step_graphs._graphs.items() if key[0] == step][-1]


def replay_ms(torch, step_graphs, step: str, iters: int = 5) -> float:
    """Median CUDA-event time of one replay of the last captured ``step``
    of a StepGraphs: the card's time for the step's kernels back to back.
    (A replay writes the step's K/V again, at the same positions, with the
    same values.)"""
    graph = last_captured(step_graphs, step).graph
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def step_profile(torch, run_once, wall_s: float, step_graphs, step: str, capture: bool,
                 replays: int = 1, sums=None, top_ops: int = 0) -> dict:
    """:func:`device_profile` of a serving step, captured or eager.  A
    captured step also gets its replay's CUDA-event time
    (``replay_ms``, times ``replays`` replays a run); where the profiler
    shows the replays only as ``cudaGraphLaunch``, with no kernels in them,
    that time stands for the card's busy time (``busy_from``)."""
    prof = device_profile(torch, run_once, wall_s, sums, top_ops)
    prof["captured"] = capture
    prof["busy_from"] = "profiler"
    if capture:
        from repro_torch.serve import graphs

        held = last_captured(step_graphs, step).launches
        prof["launches_per_replay"] = {f"{fn.__name__}.{attr}": n for (fn, attr), n
                                       in zip(graphs.COUNTERS, held) if n}
        prof["replay_ms"] = replay_ms(torch, step_graphs, step) * replays
        if prof["device_busy_ms"] < 0.05 * prof["replay_ms"]:
            prof["busy_from"] = "cuda_events (the profiler shows the replay as cudaGraphLaunch)"
            prof["device_busy_ms"] = prof["replay_ms"]
            prof["device_busy_share"] = prof["replay_ms"] / prof["wall_ms"]
    return prof


def x32_kernel(name: str) -> bool:
    """A device kernel of the f32-activation entries (either order)."""
    return "mpmm_x32_tc_kernel" in name


def cnn_run(torch, gpu) -> None:
    """The paper's CNN path on the card: ResNet18 through run_network, in
    float32 as the JAX example and ``launch.cnn`` run it (the f32-activation
    entries), then in bf16 (the bf16 kernels), then the entry point itself."""
    import io

    from repro_torch.core.perfmodel import select_dataflow
    from repro_torch.core.precision import Precision
    from repro_torch.kernels import ops
    from repro_torch.launch import cnn as cnn_cli
    from repro_torch.models import cnn

    b = 8
    layers, params = cnn.init_network("ResNet18", 0, w_bits=8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x32 = torch.randn(b, 224, 224, 3, generator=gen, device="cuda")
    x = x32.to(torch.bfloat16)
    cpu_params = [(wd.cpu(), ws.cpu()) for wd, ws in params]

    def run(inp, prm, lyr, device="cuda", w_bits=8):
        out, dec = cnn.run_network("ResNet18", inp, prm, lyr, w_bits=w_bits, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, dec

    def measured(inp, sums):
        """Decisions, output, median wall of 5 runs, peak and one profiled run."""
        out, decisions = run(inp, params, layers)
        ff = [d for d in decisions if d.endswith(": ff")]
        cf = [d.split(":")[0] for d in decisions if d.endswith(": cf")]
        check(len(ff) == 17 and cf == CF_LAYERS, f"ResNet18 w8 decisions ({inp.dtype}): "
              f"{len(ff)} FF, CF at {cf} (expected 17 FF, the 3 downsamples)")
        check(tuple(out.shape) == (b, 7, 7, 512) and out.dtype == inp.dtype
              and bool(torch.isfinite(out).all()),
              f"ResNet18 output {tuple(out.shape)} {out.dtype} is not finite [8, 7, 7, 512]")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run(inp, params, layers)
            times.append(time.perf_counter() - t0)
        wall = sorted(times)[len(times) // 2]
        peak = torch.cuda.max_memory_allocated()
        profile = device_profile(torch, lambda: run(inp, params, layers), wall, sums=sums)
        return decisions, len(ff), len(cf), wall, peak, profile

    # ---- float32: the entry point's type; card vs CPU at batch 2 within
    # CNN_F32_RTOL of the output's largest value (f32 summation order)
    decisions, n_ff, n_cf, wall, peak, profile = measured(x32, {"x32": x32_kernel})
    check(profile["x32"]["launches"] > 0, "the profiled f32 run shows no f32-activation kernel")
    card2, _ = run(x32[:2], params, layers)
    t0 = time.perf_counter()
    cpu2, _ = run(x32[:2].cpu(), cpu_params, layers, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff, big = (card2.cpu() - cpu2).abs(), cpu2.abs().max().item()
    emit({"phase": "cnn", "model": "ResNet18 (20 convs, 224x224x3)", "dtype": "float32",
          "w_bits": 8, "batch": b, "strategy": "mixed", "decisions": decisions,
          "ff_layers": n_ff, "cf_layers": n_cf, "images_per_s": b / wall,
          "wall_ms_p50": wall * 1e3, "peak_mem_gb": peak / 1e9,
          "card_vs_cpu_batch": 2, "max_abs_err": diff.max().item(),
          "mean_abs_err": diff.mean().item(), "out_abs_max": big,
          "tol": f"atol {CNN_F32_RTOL} x out_abs_max, rtol {CNN_F32_RTOL}",
          "cpu_f32_s": cpu_s, "profile": profile, "gpu": gpu})
    check(bool((diff <= CNN_F32_RTOL * big + CNN_F32_RTOL * cpu2.abs()).all()),
          f"ResNet18 f32 card vs CPU differ by max {diff.max().item():.4g} (largest |out| "
          f"{big:.4g}, tolerance {CNN_F32_RTOL} of it)")
    del card2, cpu2

    # ---- bf16: the bf16 kernels on the same network; card vs CPU at batch
    # 2: the CPU's bf16 run against its float32 run is the noise; the card's
    # bf16 run must be as close to the CPU's bf16 run as twice that, in the
    # largest and the mean difference (as in phase 3)
    decisions, n_ff, n_cf, wall, peak, profile = measured(x, {"ff_dequant": ff_kernel})
    check(profile["ff_dequant"]["launches"] > 0, "the profiled run shows no FF kernel")
    x2 = x[:2]
    card2, _ = run(x2, params, layers)
    t0 = time.perf_counter()
    cpu16, _ = run(x2.cpu(), cpu_params, layers, device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu32, _ = run(x2.cpu().float(), cpu_params, layers, device="cpu")
    card2 = card2.cpu().float()
    diff, noise = (card2 - cpu16.float()).abs(), (cpu32 - cpu16.float()).abs()
    emit({"phase": "cnn_bf16", "model": "ResNet18 (20 convs, 224x224x3)", "dtype": "bfloat16",
          "w_bits": 8, "batch": b, "strategy": "mixed", "decisions": decisions,
          "ff_layers": n_ff, "cf_layers": n_cf, "images_per_s": b / wall,
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

    # ---- the entry point, as a user runs it (python -m repro_torch.launch.cnn
    # --net ResNet18 --layers 20): float32 on the card against --device cpu,
    # the same seeded input and weights
    reports = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            reports[device] = cnn_cli.main(["--net", "ResNet18", "--layers", "20",
                                            "--device", device])
            if device == "cuda":
                torch.cuda.synchronize()
            reports[device]["wall_s"] = time.perf_counter() - t0
    card, cpu = reports["cuda"], reports["cpu"]
    got, exp = card["activation"].cpu(), cpu["activation"]
    diff, big = (got - exp).abs(), exp.abs().max().item()
    emit({"phase": "cnn_entry_point", "argv": "--net ResNet18 --layers 20",
          "dtype": card["dtype"], "shape": list(card["shape"]), "finite": card["finite"],
          "decisions_equal": card["decisions"] == cpu["decisions"],
          "max_abs_err": diff.max().item(), "out_abs_max": big,
          "wall_s": [card["wall_s"], cpu["wall_s"]], "order": "[card, cpu]", "gpu": gpu})
    check(card["dtype"] == "torch.float32" and card["finite"]
          and card["decisions"] == cpu["decisions"], f"launch.cnn on the card: {card['dtype']}, "
          f"finite {card['finite']}, decisions equal {card['decisions'] == cpu['decisions']}")
    check(bool((diff <= CNN_F32_RTOL * big + CNN_F32_RTOL * exp.abs()).all()),
          f"launch.cnn card vs CPU differ by max {diff.max().item():.4g} (largest |out| "
          f"{big:.4g})")

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
def mixed_precision(i: int) -> dict:
    w, kv = PRECISIONS[i % len(PRECISIONS)]
    return {"w_bits": w, "kv_bits": kv}


def w8kv8(i: int) -> dict:
    return {"w_bits": 8, "kv_bits": 8}


def mixed_spec(i: int) -> dict:
    """Phase 5's (w, kv) cycle, the second four requests speculative
    (spec_k SPEC_K, a w4 draft): each precision serves one of each."""
    return {**mixed_precision(i), "spec_k": SPEC_K if i >= len(PRECISIONS) else 0}


def gemma_precision(i: int) -> dict:
    w, kv = GEMMA_PRECISIONS[i % len(GEMMA_PRECISIONS)]
    return {"w_bits": w, "kv_bits": kv}


def mixtral_precision(i: int) -> dict:
    w, kv = MIXTRAL_PRECISIONS[i % len(MIXTRAL_PRECISIONS)]
    return {"w_bits": w, "kv_bits": kv}


def greedy(i: int) -> dict:
    return {}


def sampled(i: int) -> dict:
    """Phase 5's sampled traffic: temperature 0.8, top_p 0.95, top_k 50 on
    every other request, seed = the request's index."""
    return {"temperature": 0.8, "top_p": 0.95, "top_k": 50 if i % 2 == 0 else 0, "seed": i}


def mixed_sampling(i: int) -> dict:
    """Greedy on even requests, phase 5's sampled traffic on odd ones."""
    return sampled(i) if i % 2 else {}


def temperature_only(i: int) -> dict:
    """Temperature 0.8 alone, seed = the request's index."""
    return {"temperature": 0.8, "seed": i}


def engine_run(torch, seed: int, cfg, sampling=greedy, precision=mixed_precision,
               spec_k: int = 0, draft_bits: int = 4, capture: bool = True, mesh=None):
    """Serve phase 5's traffic once: request i takes ``sampling(i)`` and
    ``precision(i)`` (keyword arguments of SamplingParams / PrecisionParams);
    ``spec_k`` and ``draft_bits`` are the engine's; the group calls are
    captured (or eager: ``capture=False``); ``ServeEngine(mesh=)`` with a
    mesh.  Returns (streams, stats, peak bytes, s, the engine's captured
    steps: {captured, replays, capture_s})."""
    import gc

    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    gc.collect()  # an earlier engine's pools, in a cycle with its prefix cache
    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                         num_pages=8 * 40, spec_k=spec_k, draft_bits=draft_bits, device="cuda",
                         mesh=mesh)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, 256).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 256).astype(np.int32)])
               for _ in range(8)]

    def submit(i):
        return engine.submit(prompts[i], SamplingParams(max_new_tokens=32, **sampling(i)),
                             PrecisionParams(**precision(i)))

    t0 = time.perf_counter()
    with capturing(capture):
        # the first request of each precision warms the shared system prompt;
        # the rest arrive once it is cached, as followers of a system prompt do
        first = [submit(i) for i in range(len(PRECISIONS))]
        while not all(r.out_tokens for r in first):
            engine.step()
        reqs = first + [submit(i) for i in range(len(PRECISIONS), 8)]
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
    steps = captured_steps(engine)
    del engine, params
    torch.cuda.empty_cache()
    return [tuple(r.out_tokens) for r in reqs], stats, peak, wall, steps


def engine_prefill_profile(torch, cfg, capture: bool = True) -> dict:
    """One chunk-prefill group call of the full engine under torch.profiler,
    captured (or eager).  Four w8/kv8 requests of 512 random prompt tokens
    with a 128-token chunk: every engine step prefills one chunk of all four
    in one group call (one chunk_prefill_step of 4 x 128 tokens).  Step 1
    warms up (and captures), step 2 (128 tokens of context) is timed without
    the profiler, step 3 (256 of context) runs under it: device time by
    kernel, and the card's busy share of step 2's wall time."""
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
        with capturing(capture):
            engine.step()
        torch.cuda.synchronize()

    step()
    chunks = engine.stats.prefill_chunks
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    prof = step_profile(torch, step, wall, engine.graphs, "chunk", capture)
    check(engine.stats.prefill_chunks == chunks + 2,
          f"profiled engine steps ran {engine.stats.prefill_chunks - chunks} prefill "
          "group calls, expected one each")
    del engine, params
    torch.cuda.empty_cache()
    return {"requests": 4, "prompt": 512, "chunk": 128, "w_bits": 8, "kv_bits": 8,
            "group_call_ms": wall * 1e3, **prof}


def engine_decode_profile(torch, cfg, capture: bool = True) -> dict:
    """One decode step of the full engine under torch.profiler, captured (or
    eager): eight w8/kv8 requests of 512 random prompt tokens, prefilled in
    128-token chunks, then decoding as one group of 8 rows (one
    paged_decode_step: 28 layers of paged decode at ctx ~515).  The first
    pure decode step warms up (and captures), the second is timed without
    the profiler, the third runs under it: paged decode's device time and
    launches, and the card's busy share of the second step's wall time."""
    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(11))
    engine = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                         num_pages=8 * 40, device="cuda")
    rng = np.random.default_rng(11)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, 512).astype(np.int32),
                          SamplingParams(max_new_tokens=16), PrecisionParams(w_bits=8, kv_bits=8))
            for _ in range(8)]

    def step():
        with capturing(capture):
            engine.step()
        torch.cuda.synchronize()

    while not all(r.out_tokens for r in reqs):
        step()
    step()
    steps, chunks = engine.stats.decode_steps, engine.stats.prefill_chunks
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    # the kernel and its merge launch
    prof = step_profile(torch, step, wall, engine.graphs, "decode", capture,
                        sums={"paged_decode": lambda name: "paged_decode" in name})
    check(engine.stats.decode_steps == steps + 2 and engine.stats.prefill_chunks == chunks,
          "the profiled engine steps were not one decode group call each")
    ctx = [r.cache_len for r in reqs]
    del engine, params
    torch.cuda.empty_cache()
    pd = prof["paged_decode"]
    return {"requests": 8, "prompt": 512, "w_bits": 8, "kv_bits": 8, "rows": 8,
            "ctx_after": ctx, "decode_step_ms": wall * 1e3,
            "paged_decode_share_of_busy": pd["device_ms"] / max(prof["device_busy_ms"], 1e-9),
            **prof}


def verify_m_kernel(name: str) -> bool:
    """A device kernel of the CF dequant matmul above decode M: the
    tensor-core kernel's 64- or 128-row tile (in a spec round: the verify's
    M = 8 x (spec_k + 1) rows)."""
    return "mpmm_tc_kernel" in name and not decode_m_kernel(name) and not ff_kernel(name)


def spec_round_profile(torch, cfg, capture: bool = True) -> dict:
    """One speculative round of the full engine under torch.profiler,
    captured (or eager): eight
    requests of 512 random prompt tokens, w8 target, w4 draft, kv8,
    SPEC_K = 4, prefilled in 128-token chunks, then decoding as one spec
    group of 8 rows (4 draft steps of paged decode at M = 8, one verify
    window through paged prefill at M = 40).  The first round warms up, the
    second is timed without the profiler, the third runs under it: paged
    prefill (the verify), paged decode (the drafts) and the CF matmul at
    verify M, by device time and launches, and the card's busy share of the
    second round's wall time."""
    import numpy as np

    from repro_torch.kernels.mpmm import mpmm_cuda
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda
    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(13))
    engine = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                         num_pages=8 * 48, spec_k=SPEC_K, draft_bits=4, device="cuda")
    rng = np.random.default_rng(13)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, 512).astype(np.int32),
                          SamplingParams(max_new_tokens=64), PrecisionParams(w_bits=8, kv_bits=8))
            for _ in range(8)]

    def step():
        with capturing(capture):
            engine.step()
        torch.cuda.synchronize()

    while not all(r.out_tokens for r in reqs):
        step()
    step()
    rounds, chunks = engine.stats.spec_rounds, engine.stats.prefill_chunks
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    counters = {"paged_prefill_verify": (paged_mqa_prefill_cuda, "launches"),
                "paged_decode_draft": (paged_mqa_decode_cuda, "launches"),
                "mpmm_verify_m": (mpmm_cuda, "prefill_m_launches")}
    before = {k: getattr(*c) for k, c in counters.items()}
    prof = step_profile(torch, step, wall, engine.graphs, "spec", capture, sums={
        "paged_prefill_verify": lambda name: "paged_prefill" in name,
        "paged_decode_draft": lambda name: "paged_decode" in name,
        "mpmm_verify_m": verify_m_kernel,
        "mpmm_decode_m_draft": decode_m_kernel,
    })
    # the launches of the profiled round by the wrappers' counts (a replay
    # adds its capture's); paged decode's merge launches are not counted
    prof["counted"] = {k: getattr(*c) - before[k] for k, c in counters.items()}
    check(engine.stats.spec_rounds == rounds + 2 and engine.stats.prefill_chunks == chunks,
          "the profiled engine steps were not one spec round each")
    verifies = [prof["counted"]["paged_prefill_verify"]]
    if prof["busy_from"] == "profiler":
        verifies.append(prof["paged_prefill_verify"]["launches"])
    for n in verifies:
        check(n == cfg.n_layers, f"the profiled round shows {n} paged prefill launches, "
              f"expected one verify per layer ({cfg.n_layers})")
    check(prof["counted"]["paged_decode_draft"] == SPEC_K * cfg.n_layers,
          "the profiled round counts other than SPEC_K paged decode launches a layer")
    if prof["busy_from"] == "profiler":
        check(prof["paged_decode_draft"]["launches"] >= SPEC_K * cfg.n_layers,
              "the profiled round shows fewer paged decode launches than SPEC_K drafts a layer")
    ctx = [r.cache_len for r in reqs]
    del engine, params
    torch.cuda.empty_cache()
    return {"requests": 8, "prompt": 512, "w_bits": 8, "draft_bits": 4, "kv_bits": 8,
            "spec_k": SPEC_K, "rows": 8, "ctx_after": ctx, "round_ms": wall * 1e3, **prof}


# --------------------------------------------------------------- phase 7
def ptxas_report(lib_path: Path, kernel: str = "paged_prefill_kernelILi256E",
                 names: tuple = ("kv_bits",)) -> list:
    """Registers, stack and spill bytes that ``ptxas -v`` gave each kernel
    instantiation whose mangled name holds ``kernel`` (the build's log
    beside the library), with the integer template arguments that follow
    ``kernel`` in the name under ``names``: by default bf16 paged prefill at
    DP = 256, one per kv_bits."""
    out, cur = [], False
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            cur = kernel in name
            if cur:
                args = re.findall(r"Li(\d+)E", name[name.index(kernel) + len(kernel):])
                out.append({k: int(v) for k, v in zip(names, args)})
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[-1].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                           spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m[1])
    return out


def moe_counters(torch):
    """Wrap ``models.moe.moe_ffn`` so that every call also counts the CF
    kernel's launches made within it (``mpmm_cuda.launches``, read before
    and after) and, on the card, the top-k assignments dropped at capacity
    and all its assignments (padding rows' included).  For an eager run
    whose times are not reported: the wrapper routes the tokens once more,
    and ``read()`` reads the card back.  Returns (read, restore)."""
    from repro_torch.kernels.mpmm import mpmm_cuda
    from repro_torch.models import moe as moe_mod

    real = moe_mod.moe_ffn
    expert_launches = [0]
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")

    def counted(x, params, *, top_k, capacity_factor=1.25, dispatch="replicated"):
        x2 = x.reshape(-1, x.shape[-1])
        e = params["router"].shape[-1]
        _, eids, _, _ = moe_mod._route(x2, params["router"], top_k)
        cap = int(max(1, (x2.shape[0] * top_k * capacity_factor) // e))
        pos = moe_mod._positions_in_expert(eids.reshape(-1), e)
        counts[0].add_((pos >= cap).sum())
        counts[1].add_(pos.numel())
        before = mpmm_cuda.launches
        out = real(x, params, top_k=top_k, capacity_factor=capacity_factor, dispatch=dispatch)
        expert_launches[0] += mpmm_cuda.launches - before
        return out

    def read():
        dropped, assigned = counts.tolist()
        return {"cf_launches": mpmm_cuda.launches, "expert_cf_launches": expert_launches[0],
                "dropped_assignments": dropped, "assignments": assigned}

    moe_mod.moe_ffn = counted
    return read, lambda: setattr(moe_mod, "moe_ffn", real)


def serve_run(torch, cfg, seed: int, requests: int, prompt: int, new: int, precision,
              capture: bool = True, spec_k: int = 0, draft_bits: int = 4, per_step=None,
              mesh=None):
    """Serve ``requests`` greedy requests of ``prompt`` random tokens (after
    the arch's prefix embeddings, if it has a frontend), ``new`` new tokens
    each, request i at ``precision(i)``, through
    ServeEngine (8 slots, 16-token pages, 128-token chunks; ``spec_k`` and
    ``draft_bits`` the engine's), weights drawn from ``seed``, the steps
    captured (or eager), ``ServeEngine(mesh=)`` with a mesh.  ``per_step()``
    returns a dict of counts, read
    after every engine step (each step already reads its tokens back).
    Returns (streams, stats, peak bytes, wall s, captured steps, per-step
    differences of ``per_step``)."""
    import gc

    import numpy as np

    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    gc.collect()  # an earlier engine's pools, in a cycle with its prefix cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    pages = -(-(cfg.prefix_len + prompt + new + spec_k + 8) // 16)
    engine = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                         num_pages=requests * pages, spec_k=spec_k, draft_bits=draft_bits,
                         device="cuda", mesh=mesh)
    del params
    rng = np.random.default_rng(seed)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, prompt).astype(np.int32),
                          SamplingParams(max_new_tokens=new), PrecisionParams(**precision(i)))
            for i in range(requests)]
    deltas, last = [], per_step() if per_step else None
    t0 = time.perf_counter()
    with capturing(capture):
        while not all(r.done for r in reqs):
            check(engine.step(), f"{cfg.name}: the engine stalled")
            if per_step:
                now = per_step()
                deltas.append({k: now[k] - last[k] for k in now})
                last = now
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        check(len(r.out_tokens) == new, f"{cfg.name} request {r.rid}: {len(r.out_tokens)} "
              f"tokens, expected {new}")
        check(all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"{cfg.name} request {r.rid}: token outside the vocabulary")
    steps = captured_steps(engine)
    peak = torch.cuda.max_memory_allocated()
    stats = engine.stats
    del engine
    torch.cuda.empty_cache()
    return [tuple(r.out_tokens) for r in reqs], stats, peak, wall, steps, deltas


def captured_steps(engine) -> dict:
    """An engine's captured steps: {captured, replays, capture_s}, the paged
    attention launches (either kernel, either instantiation) a replay of
    each step adds, by step name, and, on a mesh, the splits its step keys
    name (``ServeEngine.split``)."""
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda
    from repro_torch.serve.graphs import COUNTERS

    paged = {}
    for key, g in engine.graphs._graphs.items():
        n = sum(d for (fn, _), d in zip(COUNTERS, g.launches)
                if fn in (paged_mqa_decode_cuda, paged_mqa_prefill_cuda))
        paged.setdefault(key[0], set()).add(n)
    steps = {"captured": engine.graphs.captured, "replays": engine.graphs.replays,
             "capture_s": engine.graphs.capture_s,
             "paged_launches_per_replay": {k: sorted(v) for k, v in paged.items()}}
    if engine.mesh is not None:
        steps["splits"] = sorted({repr(key[2][-1]) for key in engine.graphs.calls})
    return steps


def serve_summary(stats, peak, wall, steps) -> dict:
    """The numbers of a serve_run for its JSON line."""
    return {"tokens_out": stats.tokens_out, "decode_tok_per_s": stats.decode_tok_per_s,
            "decode_s": stats.decode_s, "decode_call_ms_p50": _p50(stats.decode_call_s) * 1e3,
            "prefill_s": stats.prefill_s, "prefill_chunks": stats.prefill_chunks,
            "ttft_ms_first": min(stats.ttfts) * 1e3, "ttft_ms_last": max(stats.ttfts) * 1e3,
            "decode_group_calls": {f"w{w}kv{k}": n for (w, k), n in stats.group_calls.items()},
            "mixed_precision_steps": stats.mixed_precision_steps,
            "spec_rounds": stats.spec_rounds, "spec_accept_rate": stats.spec_accept_rate,
            "wall_s": wall, "peak_mem_gb": peak / 1e9, "captured_steps": steps}


def _p50(samples) -> float:
    ordered = sorted(samples)
    return ordered[len(ordered) // 2]


# --------------------------------------------------------------- phase 8
def pali_precision(i: int) -> dict:
    w, kv = PALI_PRECISIONS[i % len(PALI_PRECISIONS)]
    return {"w_bits": w, "kv_bits": kv}


def music_precision(i: int) -> dict:
    w, kv = MUSIC_PRECISIONS[i % len(MUSIC_PRECISIONS)]
    return {"w_bits": w, "kv_bits": kv}


def prefix_draw_card_vs_cpu(torch, cfg, batch: int) -> dict:
    """The frontend's standard normals (``prng.normal``, before the
    1/sqrt(d_model) scaling) drawn on the card and on the CPU from the same
    key: the uniforms are integer hashes, so the draws may differ only where
    ``log1p`` or ``sqrt`` round otherwise, within 8 float32 ulps of the
    largest draw."""
    from repro_torch.kernels import prng

    shape = (batch, cfg.prefix_len, cfg.d_model)
    key = prng.fold_in(prng.prng_key(0), batch)
    card = prng.normal(key.cuda(), shape).cpu()
    cpu = prng.normal(key, shape)
    err = (card - cpu).abs().max().item()
    top = cpu.abs().max().item()
    tol = 8 * 2.0 ** (math.floor(math.log2(top)) - 23)
    check(bool(torch.isfinite(card).all()) and err <= tol,
          f"{cfg.name} prefix draw: card vs CPU differ by {err:.3g} (tolerance {tol:.3g})")
    return {"shape": list(shape), "max_abs_err": err, "tol": tol,
            "equal_fraction": (card == cpu).float().mean().item()}


def prefix_step_card_vs_cpu(torch, gpu, base, layers: int = 2, prompt: int = 32) -> None:
    """The one-shot prefix prefill of ``base`` cut to ``layers`` layers at
    full width (``transformer.prefill`` over the prefix embeddings and 2
    rows of ``prompt`` tokens, its contiguous cache written into pages by
    ``PagedKVCache.write_prompt``) and one paged decode step after it, on
    the card (kernels) and on the CPU (plain versions), for three (w_bits,
    kv_bits) pairs, judged by phase 3's rule with float32 and the card with
    plain paged attention as witnesses on near-tied rows (``witness_all``:
    257216 random logits).  Both runs take the CPU's prefix draw.  The card
    runs the step in float32 too, held to the CPU's float32 run by
    compare_logits_f32."""
    from repro_torch.models import transformer as model_lib
    from repro_torch.models.frontends import prefix_embeddings
    from repro_torch.serve import decode
    from repro_torch.serve.kv_cache import PagedKVCache

    arch, depth = base.name, base.n_layers
    base = dataclasses.replace(base, n_layers=layers)
    params16 = model_lib.init_params(base, torch.Generator(device="cuda").manual_seed(1))
    gen = torch.Generator().manual_seed(1)
    b, ps = 2, 16
    plen = base.prefix_len + prompt
    prefix = prefix_embeddings(base, b, device="cpu")
    tokens = torch.randint(0, base.vocab, (b, prompt), generator=gen)
    next_tokens = torch.randint(0, base.vocab, (b, 1), generator=gen)
    for w_bits, kv_bits in ((4, 8), (16, 16), (8, 4)):
        cfg = dataclasses.replace(base, serve_kv_bits=kv_bits)
        params = params16 if w_bits == 16 else model_lib.quantize_params(params16, w_bits)
        cpu_params = _tree_map(params, lambda t: t.cpu())  # copied once for both CPU runs

        def run(device, wide=False):
            """(prefill logits, decode logits) on ``device``; ``wide`` runs
            the model in float32 (bf16 weights widen exactly)."""
            def to(t):
                if t is None:
                    return None
                t = t.to(device)
                return t.float() if wide and t.dtype == torch.bfloat16 else t

            p = _tree_map(params if device == "cuda" else cpu_params, to)
            run_cfg = dataclasses.replace(cfg, dtype="float32") if wide else cfg
            cache = PagedKVCache(run_cfg, num_pages=b * (plen // ps + 2), page_size=ps,
                                 kv_bits=kv_bits, device=device)
            max_len = cache.pages_for(plen) * ps
            logits_p, kv = model_lib.prefill(
                p, {"tokens": to(tokens), "prefix_emb": to(prefix)}, run_cfg, max_len)
            for i in range(b):
                cache.allocate(i, cache.pages_for(plen))
                cache.write_prompt(i, *(kv[n][:, i] for n in ("k", "v", "k_scale", "v_scale")
                                        if n in kv))
                cache.extend(i, 1)  # the decode step's token opens a page
            tables = torch.from_numpy(cache.table_array(list(range(b)), len(cache.table(0))))
            lengths = torch.full((b,), plen, dtype=torch.int32)
            valid = torch.ones(b, dtype=torch.bool)
            logits_d, _ = decode.paged_decode_step(
                p, to(next_tokens), to(lengths), to(tables), to(valid), *cache.pools,
                cfg=run_cfg)
            return logits_p.cpu()[:, : cfg.vocab], logits_d.cpu()[:, : cfg.vocab]

        t0 = time.perf_counter()
        on_card = run("cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = run("cpu")
        t_cpu = time.perf_counter() - t0
        cpu32 = run("cpu", wide=True)
        t0 = time.perf_counter()
        card32 = run("cuda", wide=True)
        t_card32 = time.perf_counter() - t0
        with plain_paged_attention():
            plain = run("cuda")
        rec = {"phase": "step_prefix", "model": f"{arch} ({layers} of {depth} layers, full width)",
               "w_bits": w_bits, "kv_bits": kv_bits, "batch": b, "prefix": base.prefix_len,
               "prompt": prompt, "card_s": t_card, "cpu_s": t_cpu, "card_f32_s": t_card32,
               "gpu": gpu}
        for i, name in enumerate(("prefill", "decode")):
            compare_logits(torch, rec, name, f"{arch} one-shot {name} w{w_bits}kv{kv_bits}",
                           on_card[i], cpu[i], cpu32[i], kv_bits, True, plain[i])
            compare_logits_f32(torch, rec, name, f"{arch} one-shot {name} w{w_bits}kv{kv_bits}",
                               card32[i], cpu32[i], cpu[i])
        emit(rec)
        del params, cpu_params
    del params16


def isa_on_card(torch, gpu) -> None:
    """The paper's executable core on the card.  (a) The SAU model's 4-bit
    multiplier combination (``core.sau``) on CUDA tensors: ``pe_multiply``
    over every INT4 operand pair and 2**20 random INT8 / INT16 pairs, and
    ``SAU(bit_accurate=True)`` tiles, bit-equal to the CPU.  (b) An ISA
    program: ISA_LAYER assembled by ``assemble_conv`` and run by
    ``run_program`` (numpy, on the CPU) against the same conv through the
    int-mode matmul on the card, its patches as ``ops.mpconv`` forms them
    (NHWC, feature order (cin, kh, kw)), FF and CF: bit-exact at INT4 (int4
    weights, int8 activations), INT8 and INT16."""
    import numpy as np

    from repro_torch.core import sau
    from repro_torch.core.assembler import assemble_conv
    from repro_torch.core.dataflow import ConvLayer
    from repro_torch.core.interpreter import run_program
    from repro_torch.core.isa import Dataflow
    from repro_torch.core.precision import Precision
    from repro_torch.kernels import ref
    from repro_torch.kernels.mpmm import mpmm_int_cuda
    from repro_torch.quant.pack import pack_int4

    rng = np.random.default_rng(0)
    tile = sau.SAU(tile_r=4, tile_c=4)
    layer = ConvLayer("isa", **ISA_LAYER)
    for prec in (Precision.INT4, Precision.INT8, Precision.INT16):
        spec = prec.spec
        if prec is Precision.INT4:
            vals = torch.arange(spec.qmin, spec.qmax + 1, dtype=torch.int32)
            a, b = vals[:, None].expand(16, 16), vals[None, :].expand(16, 16)
        else:
            a, b = (torch.from_numpy(rng.integers(spec.qmin, spec.qmax + 1, 1 << 20)
                                     .astype(np.int32)) for _ in range(2))
        prod = sau.pe_multiply(a.cuda(), b.cuda(), prec).cpu()
        check(torch.equal(prod, sau.pe_multiply(a, b, prec)) and
              torch.equal(prod.long(), a.long() * b.long()),
              f"pe_multiply {prec.name} on the card != the CPU / the direct product")
        tiles = [(torch.from_numpy(rng.integers(spec.qmin, spec.qmax + 1, (4, 24))
                                   .astype(np.int32)),
                  torch.from_numpy(rng.integers(spec.qmin, spec.qmax + 1, (24, 4))
                                   .astype(np.int32))) for _ in range(8)]
        acc = torch.zeros(4, 4, dtype=torch.int32)
        for x, w in tiles:
            got = tile(acc.cuda(), x.cuda(), w.cuda(), prec, bit_accurate=True).cpu()
            check(torch.equal(got, tile(acc, x, w, prec, bit_accurate=True)) and
                  torch.equal(got, tile(acc, x, w, prec)),
                  f"SAU(bit_accurate=True) {prec.name} on the card != the CPU")
        # the program and the int-mode matmul on one conv
        lim = (spec.qmin, spec.qmax + 1)
        x = rng.integers(*lim, (layer.cin, layer.h, layer.w)).astype(np.int32)
        w = rng.integers(*lim, (layer.cout, layer.cin, layer.k, layer.k)).astype(np.int32)
        x_dtype = torch.int16 if prec is Precision.INT16 else torch.int8
        xi = torch.from_numpy(x).permute(1, 2, 0)[None].to(x_dtype).cuda()
        patches = ref.conv_patches(xi, layer.k, layer.stride, layer.padding)
        patches = patches.reshape(-1, patches.shape[-1]).contiguous()
        wk = torch.from_numpy(w).permute(1, 2, 3, 0).reshape(-1, layer.cout)
        wd = wk.to(torch.int16 if prec is Precision.INT16 else torch.int8)
        if prec is Precision.INT4:
            wd = pack_int4(wd, dim=-2)
        wd = wd.contiguous().cuda()
        rec = {"phase": "isa_program", "layer": ISA_LAYER, "precision": prec.name,
               "pe_multiply_pairs": a.numel(), "sau_tiles": len(tiles), "gpu": gpu}
        for df in (Dataflow.FF, Dataflow.CF):
            prog = assemble_conv(layer, x, w, prec, df)
            t0 = time.perf_counter()
            exp = run_program(prog)
            sim_s = time.perf_counter() - t0
            before = mpmm_int_cuda.launches
            got = mpmm_int_cuda(patches, wd, w_bits=spec.bits, dataflow=df.name.lower())
            check(mpmm_int_cuda.launches == before + 1, "the int-mode matmul did not launch")
            got = got.reshape(layer.h_out, layer.w_out, layer.cout).permute(2, 0, 1).cpu()
            check(np.array_equal(got.numpy().astype(np.int64), exp),
                  f"ISA program {prec.name} {df.name} != the int-mode matmul on the card")
            rec[df.name.lower()] = {"instructions": prog.n_instructions,
                                    "simulator_s": sim_s, "bit_exact": True}
        emit(rec)


def prefix_paths(torch, gpu, count, eager_twin) -> dict:
    """Phase 8's serving: the prefix draw and the 2-layer paligemma-3b cut
    card vs CPU, then full paligemma-3b (twice, and speculative) and full
    musicgen-medium through ServeEngine's one-shot prefix prefill, each path
    once more eager through ``eager_twin``.  ``count(path)`` runs a path
    with every launch count at 0.  Returns each path's launches."""
    from repro_torch.configs import get_config

    pali, music = get_config("paligemma-3b"), get_config("musicgen-medium")
    emit({"phase": "prefix_draw", "what": "the frontend's standard normals for 8 requests "
          "drawn on the card against the CPU's draw",
          "draws": {c.name: prefix_draw_card_vs_cpu(torch, c, 8) for c in (pali, music)},
          "gpu": gpu})
    prefix_step_card_vs_cpu(torch, gpu, pali)
    torch.cuda.empty_cache()

    def prefix_checks(name, stats, requests=8):
        check(stats.tokens_out == requests * PREFIX_NEW,
              f"{name} tokens_out {stats.tokens_out} != {requests * PREFIX_NEW}")
        check(stats.prefills == requests and stats.prefill_chunks == 0
              and stats.prefix_hit_tokens == 0,
              f"{name}: {stats.prefills} prefills, {stats.prefill_chunks} chunk calls, "
              f"{stats.prefix_hit_tokens} prefix hits: not the one-shot prefill alone")

    def pali_run(capture=True):
        return serve_run(torch, pali, 0, 8, PREFIX_PROMPT, PREFIX_NEW, pali_precision, capture)

    (p_streams, p_stats, p_peak, p_wall, p_steps, _), pali_launches = count(pali_run)
    emit({"phase": "engine_paligemma", "model": "paligemma-3b (18 layers, full width)",
          "requests": 8, "prefix": pali.prefix_len, "prompt": PREFIX_PROMPT,
          "new_tokens": PREFIX_NEW, "precisions": PALI_PRECISIONS,
          **serve_summary(p_stats, p_peak, p_wall, p_steps), "launches": pali_launches,
          "gpu": gpu})
    prefix_checks("paligemma-3b", p_stats)
    p_streams2, p_stats2, _, p_wall2, _, _ = pali_run()
    check(p_streams == p_streams2, "paligemma-3b: a second run with the same seed gave other "
          "streams")
    emit({"phase": "engine_paligemma_repeat", "identical_streams": True,
          "decode_tok_per_s": p_stats2.decode_tok_per_s, "prefill_s": p_stats2.prefill_s,
          "ttft_ms_last": max(p_stats2.ttfts) * 1e3, "wall_s": p_wall2, "gpu": gpu})
    eager_twin("paligemma-3b", "paligemma", p_streams, pali_launches, lambda: pali_run(False))
    torch.cuda.empty_cache()

    def pali_spec_run(capture=True):
        return serve_run(torch, pali, 0, 8, PREFIX_PROMPT, PREFIX_NEW, w8kv8, capture,
                         spec_k=SPEC_K, draft_bits=4)

    (ps_streams, ps_stats, ps_peak, ps_wall, ps_steps, _), pali_spec_launches = count(
        pali_spec_run)
    emit({"phase": "engine_paligemma_spec", "model": "paligemma-3b (18 layers, full width)",
          "requests": 8, "prefix": pali.prefix_len, "prompt": PREFIX_PROMPT,
          "new_tokens": PREFIX_NEW, "w_bits": 8, "draft_bits": 4, "kv_bits": 8,
          "spec_k": SPEC_K, "spec_draft_tokens": ps_stats.spec_draft_tokens,
          **serve_summary(ps_stats, ps_peak, ps_wall, ps_steps),
          "launches": pali_spec_launches, "gpu": gpu})
    prefix_checks("paligemma-3b spec", ps_stats)
    check(ps_stats.spec_rounds > 0, "paligemma-3b: no speculative round ran")
    eager_twin("paligemma-3b greedy spec, w4 draft", "paligemma_spec", ps_streams,
               pali_spec_launches, lambda: pali_spec_run(False))
    torch.cuda.empty_cache()

    def music_run(capture=True):
        return serve_run(torch, music, 0, 8, PREFIX_PROMPT, PREFIX_NEW, music_precision,
                         capture)

    (u_streams, u_stats, u_peak, u_wall, u_steps, _), music_launches = count(music_run)
    emit({"phase": "engine_musicgen", "model": "musicgen-medium (48 layers, full width)",
          "requests": 8, "prefix": music.prefix_len, "prompt": PREFIX_PROMPT,
          "new_tokens": PREFIX_NEW, "precisions": MUSIC_PRECISIONS,
          **serve_summary(u_stats, u_peak, u_wall, u_steps), "launches": music_launches,
          "gpu": gpu})
    prefix_checks("musicgen-medium", u_stats)
    eager_twin("musicgen-medium", "musicgen", u_streams, music_launches,
               lambda: music_run(False))
    torch.cuda.empty_cache()
    return {"paligemma": pali_launches, "paligemma_spec": pali_spec_launches,
            "musicgen": music_launches}


# --------------------------------------------------------------- phase 9
def trainer_run(torch, arch, tc, batch: int, capture: bool = True, attempts=None, mesh=None):
    """A Trainer on the card at ``batch`` x TRAIN_SEQ (on ``mesh`` under the
    mapping the caller installed), its steps captured (the default; a mesh
    step is not captured) or under ``graphs.disable_capture()``: one run of
    ``tc.total_steps`` steps, or with ``attempts`` driven by
    ``run_with_restarts`` (``attempts(trainer)`` gives its ``train_fn``) ->
    (trainer, run output, wall s, peak bytes, restarts)."""
    import gc

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import run_with_restarts
    from repro_torch.train import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    restarts = []
    t0 = time.perf_counter()
    with capturing(capture):
        tr = Trainer(arch=arch, tc=tc, data=DataConfig(vocab=arch.vocab, seq_len=TRAIN_SEQ,
                                                        global_batch=batch), device="cuda",
                     mesh=mesh)
        if attempts is None:
            out = tr.run(tc.total_steps)
        else:
            out = run_with_restarts(attempts(tr), on_restart=lambda n, e: restarts.append(repr(e)))
    torch.cuda.synchronize()
    return tr, out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), restarts


def trainer_profile(torch, tr, out, step: int, wall_s: float, top_ops: int = 0) -> dict:
    """One more step of a Trainer under torch.profiler, as its run took it
    (a replay of the captured step, or the eager step): the card's busy
    share of ``wall_s`` and where its device time goes (matmuls,
    elementwise and reduce kernels; the host ops with the most device time
    for an eager step).  A captured step also gets its replay's CUDA-event
    time, which stands for the busy time where the profiler sees only
    ``cudaGraphLaunch`` (``step_profile``); those replays train on."""
    from repro_torch.train.trainer import deterministic

    sums = {"gemm": lambda k: any(w in k.lower() for w in ("gemm", "nvjet", "cutlass")),
            "elementwise": lambda k: "elementwise" in k.lower(),
            "reduce": lambda k: "reduce" in k.lower()}
    inputs = tr.load(step)
    capture = tr.graphs.captured > 0
    got = {}

    def run_once():
        with capturing(capture), deterministic(tr.device):
            got["metrics"] = tr.step(out["params"], out["opt_state"], inputs)
        torch.cuda.synchronize()

    prof = step_profile(torch, run_once, wall_s, tr.graphs, "train", capture, sums=sums,
                        top_ops=top_ops)
    check(math.isfinite(float(got["metrics"]["loss"])), "non-finite loss in the profiled step")
    return {k: v for k, v in prof.items() if k != "graph_launches"}


def train_record(torch, hist, wall, peak, tr) -> dict:
    """A Trainer run's numbers: seconds a step (median after step 0, which
    holds the eager warm-up and, captured, the capture), tokens/s, peak
    memory allocated and reserved (a graph's pool stays reserved between
    replays), and the graphs' counts."""
    after = sorted(h["sec"] for h in hist[1:])
    step_s = after[(len(after) - 1) // 2]
    return {"steps_s": [h["sec"] for h in hist], "step_s_median_after_first": step_s,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "wall_s": wall,
            "peak_mem_gb": peak / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "graphs": {"captured": tr.graphs.captured, "replays": tr.graphs.replays,
                       "capture_s": tr.graphs.capture_s}}


def same_history(a, b, what: str) -> None:
    for x, y in zip(a, b):
        check(x["step"] == y["step"] and x["loss"] == y["loss"]
              and x["grad_norm"] == y["grad_norm"],
              f"{what} step {x['step']}: captured loss {x['loss']} / grad norm "
              f"{x['grad_norm']}, eager {y['loss']} / {y['grad_norm']}")
    check(len(a) == len(b), f"{what}: {len(a)} captured steps, {len(b)} eager")


def train_llama(torch, gpu) -> None:
    """(a) Full llama3.2-3b (28 layers, adamw, remat "full") through Trainer
    at the JAX launcher's defaults: batch 8 x seq 512, lr 3e-4, warm-up
    max(steps // 10, 1), no checkpoints; captured, then eager.  The captured
    run's losses, grad norms and final params must equal the eager run's
    bit for bit (the captured params are held on the host meanwhile)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig

    arch = get_config("llama3.2-3b")
    root = tempfile.mkdtemp(prefix="chip_smoke_llama_")
    tc = TrainConfig(lr=3e-4, warmup=max(TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS,
                     ckpt_every=0, ckpt_dir=root)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the bound: forward, its recompute and the backward (8 FLOP per matmul
    # parameter per token, plus the plain attention's full S x S blocks,
    # QK and PV, four passes) over the bf16 peak, then AdamW's bytes (bf16
    # params read and written, bf16 grads written and read, f32 m and v
    # read and written: 22 bytes a parameter) over the HBM rate
    d, h, kv, hd, f = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.hd, arch.d_ff
    mm_params = arch.n_layers * (d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f) \
        + d * arch.padded_vocab
    attn_flops = 4 * 4 * TRAIN_BATCH * TRAIN_SEQ ** 2 * h * hd * arch.n_layers
    flops = 8 * mm_params * tokens + attn_flops
    runs, host = {}, None
    try:
        for capture in (True, False):
            tr, out, wall, peak, _ = trainer_run(torch, arch, tc, TRAIN_BATCH, capture)
            hist = out["history"]
            for rec in hist:
                check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
                      f"llama3.2-3b train step {rec['step']}: loss {rec['loss']}, grad norm "
                      f"{rec['grad_norm']}")
            leaves = tree.leaves(out["params"])
            if capture:
                host = [p.cpu() for p in leaves]
            else:
                same_history(runs[True]["history"], hist, "llama3.2-3b")
                check(all(a.dtype == b.dtype and torch.equal(a, b.cpu())
                          for a, b in zip(host, leaves)),
                      "llama3.2-3b: the captured run's final params differ from the eager "
                      "run's")
                host = None
            n_params = sum(p.numel() for p in leaves)
            rec = train_record(torch, hist, wall, peak, tr)
            step_s = rec["step_s_median_after_first"]
            rec.update(history=hist, mfu=6 * mm_params * tokens / step_s / PEAK_FLOPS,
                       profile=trainer_profile(torch, tr, out, TRAIN_STEPS, step_s, top_ops=12))
            if capture:
                check(tr.graphs.captured == 1 and tr.graphs.replays >= TRAIN_STEPS - 1,
                      f"llama3.2-3b: {tr.graphs.captured} graphs, {tr.graphs.replays} replays")
            runs[capture] = rec
            del tr, out, leaves
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bound_s = flops / PEAK_FLOPS + 22 * n_params / HBM_BYTES_PER_S
    emit({"phase": "train_llama", "model": "llama3.2-3b (28 layers, full width)",
          "entry": "train.Trainer (mesh=None)", "optimizer": arch.optimizer,
          "remat": arch.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "order": "[captured, eager]", "bit_equal": True,
          "losses": [h["loss"] for h in runs[True]["history"]],
          "grad_norms": [h["grad_norm"] for h in runs[True]["history"]],
          "captured": {k: v for k, v in runs[True].items() if k != "history"},
          "eager": {k: v for k, v in runs[False].items() if k != "history"},
          "mfu_params": mm_params, "bound_s": bound_s, "bound_matmul_s": flops / PEAK_FLOPS,
          "bound_optimizer_s": 22 * n_params / HBM_BYTES_PER_S, "gpu": gpu})
    torch.cuda.empty_cache()


def train_mamba_resume(torch, gpu) -> None:
    """(b) Full mamba2-130m through Trainer with checkpoints, driven as
    launch/train.py drives it (run_with_restarts): one run uninterrupted
    (captured), the same run eager (bit-equal to it), and one captured run
    failing at step MAMBA_FAIL_AT and resuming from its last checkpoint,
    written into the tensors its graph holds: the final params and
    optimizer state bit-equal, and every loss of one seed equal between the
    runs.  Then one save of the final state, timed."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig

    arch = get_config("mamba2-130m")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def config(name):
            return TrainConfig(lr=3e-4, warmup=max(MAMBA_STEPS // 10, 1),
                               total_steps=MAMBA_STEPS, ckpt_every=MAMBA_CKPT_EVERY,
                               ckpt_dir=str(Path(root) / name))

        def state(out):
            return tree.leaves((out["params"], out["opt_state"]))

        runs = {}
        for capture, name in ((True, "uninterrupted"), (False, "eager")):
            tr, out, wall, peak, _ = trainer_run(
                torch, arch, config(name), TRAIN_BATCH, capture,
                lambda t: lambda start: t.run(MAMBA_STEPS, start_step=start))
            final = [t.cpu() for t in state(out)]  # before the profiled steps train on
            rec = train_record(torch, out["history"], wall, peak, tr)
            rec["profile"] = trainer_profile(torch, tr, out, MAMBA_STEPS,
                                             rec["step_s_median_after_first"])
            runs[capture] = (tr, out["history"], rec, final)
            del tr, out
        (ref, ref_hist, _, ref_final), (eager, eager_hist, _, eager_final) = \
            runs[True], runs[False]
        same_history(ref_hist, eager_hist, "mamba2-130m")
        check(ref.graphs.captured == 1 and eager.graphs.captured == 0,
              f"mamba2-130m: {ref.graphs.captured} / {eager.graphs.captured} graphs")
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(ref_final, eager_final)),
              "mamba2-130m: the captured run's final params / state differ from the eager "
              "run's")
        del ref, eager
        crash, out, _, _, restarts = trainer_run(
            torch, arch, config("crash"), TRAIN_BATCH, True,
            lambda t: lambda start: t.run(MAMBA_STEPS, start_step=start,
                                          fail_at=MAMBA_FAIL_AT if start != -1 else None))
        steps = [h["step"] for h in out["history"]]
        resumed_at = MAMBA_FAIL_AT // MAMBA_CKPT_EVERY * MAMBA_CKPT_EVERY
        check(len(restarts) == 1 and steps == list(range(MAMBA_FAIL_AT))
              + list(range(resumed_at, MAMBA_STEPS)),
              f"mamba2-130m: restarts {restarts}, steps {steps}")
        check(crash.graphs.captured == 1, f"mamba2-130m crash run: {crash.graphs.captured} "
              "graphs (the restore must write into the captured tensors)")
        ref_losses = {h["step"]: h["loss"] for h in ref_hist}
        for h in out["history"]:
            check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
                  f"mamba2-130m step {h['step']}: loss {h['loss']}")
            check(h["loss"] == ref_losses[h["step"]],
                  f"mamba2-130m step {h['step']}: loss {h['loss']} != {ref_losses[h['step']]} "
                  "in the uninterrupted run of the same seed")
        leaves = [t.cpu() for t in state(out)]
        check(len(leaves) == len(ref_final) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves, ref_final)),
            "mamba2-130m: the resumed run's params / state differ from the uninterrupted "
            "run's")
        t0 = time.perf_counter()
        crash.ckpt.save(10_000, (out["params"], out["opt_state"]), blocking=False)
        snapshot_s = time.perf_counter() - t0
        crash.ckpt.wait()
        save_s = time.perf_counter() - t0
        saved = Path(crash.ckpt.dir) / f"step_{10_000:09d}"
        nbytes = sum(f.stat().st_size for f in saved.iterdir())
        t0 = time.perf_counter()
        crash.ckpt.restore(10_000, target=(out["params"], out["opt_state"]))
        restore_s = time.perf_counter() - t0
        hist = ref_hist
        emit({"phase": "train_mamba", "model": "mamba2-130m (24 layers, full width)",
              "entry": "train.Trainer (mesh=None) through run_with_restarts",
              "optimizer": arch.optimizer, "remat": arch.remat, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "steps": MAMBA_STEPS, "ckpt_every": MAMBA_CKPT_EVERY,
              "fail_at": MAMBA_FAIL_AT, "resumed_from": resumed_at,
              "losses": [h["loss"] for h in hist],
              "grad_norms": [h["grad_norm"] for h in hist],
              "order": "[captured, eager]", "captured_equals_eager": True,
              "resume_bit_equal": True, "identical_losses": True,
              "captured": runs[True][2], "eager": runs[False][2],
              "crash_run_graphs": {"captured": crash.graphs.captured,
                                   "replays": crash.graphs.replays},
              "ckpt_bytes": nbytes, "ckpt_snapshot_s": snapshot_s, "ckpt_save_s": save_s,
              "ckpt_restore_s": restore_s, "gpu": gpu})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def hold_to_noise(torch, tag, a, e, f, worst) -> None:
    """Phase 3's rule on one tensor: the card's ``a`` against the CPU's bf16
    ``e`` within twice the CPU's own bf16-vs-float32 distance ``|f - e|``, in
    the largest and in the mean difference (reckoned on ``a``'s device);
    ``worst`` keeps the largest ratios."""
    a = a.detach().float()
    e, f = (x.detach().to(a.device).float() for x in (e, f))
    diff, noise = (a - e).abs(), (f - e).abs()
    check(bool(torch.isfinite(a).all()), f"{tag}: non-finite values")
    check(diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean(),
          f"{tag} {tuple(a.shape)}: card vs CPU max {diff.max().item():.4g} / mean "
          f"{diff.mean().item():.4g}, over twice the bf16 noise {noise.max().item():.4g} / "
          f"{noise.mean().item():.4g}")
    if noise.max() > 0:
        worst["max_ratio"] = max(worst["max_ratio"], (diff.max() / noise.max()).item())
    if noise.mean() > 0:
        worst["mean_ratio"] = max(worst["mean_ratio"], (diff.mean() / noise.mean()).item())


def token_nll(torch, params, batch, cfg):
    """Each token's f32 NLL under the model (the terms train_loss averages)."""
    from repro_torch.models import transformer as model_lib

    with torch.no_grad():
        h, _, _, _ = model_lib.forward(params, batch, cfg)
        logits = torch.matmul(h, params["unembed"].to(h.dtype)).float()[..., :cfg.vocab]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, batch["labels"][..., None].long(), dim=-1)[..., 0]
        return (logz - gold).reshape(-1)


def train_card_vs_cpu(torch, gpu, layers: int = 2, seq: int = 64) -> None:
    """(c) One train step of llama3.2-3b cut to ``layers`` layers at full
    width, batch 1 x ``seq``: the gradients taken once on the card (bf16),
    once on the CPU in bf16 and once in float32 (bf16 weights widened
    exactly), then each of adamw, adamw8bit and adafactor applied to each.
    Phase 3's rule (``hold_to_noise``) on each token's NLL (whose mean is
    the loss), every gradient leaf and every updated leaf; the losses then
    lie within twice the mean NLL noise of each other, and the grad norms
    within twice the norm of the gradients' bf16 noise (|mean(x)| <=
    mean|x|, | |a| - |b| | <= |a - b|).  adamw8bit's int8 codes differ card
    vs CPU in at most twice the share that differs between the CPU's bf16
    and float32 runs.  The float32 run's optimizer step runs on the card
    from the CPU's float32 params and gradients: its f32 arithmetic lands
    within f32 rounding of the CPU's, far below the bf16 noise it measures,
    and the CPU's time goes to the bf16 step that is held."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import transformer as model_lib
    from repro_torch.optim import make_optimizer, tree
    from repro_torch.train.trainer import _clip_by_global_norm, value_and_grad

    full = get_config("llama3.2-3b")
    base = dataclasses.replace(full, n_layers=layers)
    params16 = model_lib.init_params(base, torch.Generator(device="cuda").manual_seed(2))
    batch = make_batch(DataConfig(vocab=base.vocab, seq_len=seq, global_batch=1, seed=3), 0,
                       base, device="cpu")
    runs, times = {}, {}
    for name, device, wide in (("card", "cuda", False), ("cpu", "cpu", False),
                               ("cpu32", "cpu", True)):
        t0 = time.perf_counter()
        params = _tree_map(params16, lambda t: t.to(device).float() if wide and
                           t.dtype == torch.bfloat16 else t.to(device))
        cfg = dataclasses.replace(base, dtype="float32") if wide else base
        b = {k: v.to(device) for k, v in batch.items()}
        loss, _, grads = value_and_grad(params, b, cfg)
        raw = [g.clone() for g in grads]
        grads, gnorm = _clip_by_global_norm(grads, 1.0)
        runs[name] = {"params": params, "grads": grads, "raw": raw, "loss": float(loss),
                      "grad_norm": float(gnorm), "nll": token_nll(torch, params, b, cfg)}
        times[name] = {"grads_s": time.perf_counter() - t0}
    card, cpu, cpu32 = runs["card"], runs["cpu"], runs["cpu32"]
    rec = {"phase": "train_step", "model": f"llama3.2-3b ({layers} of {full.n_layers} "
           "layers, full width)", "batch": 1, "seq": seq, "gpu": gpu}
    worst = {"max_ratio": 0.0, "mean_ratio": 0.0}
    hold_to_noise(torch, "train step token NLL", card["nll"], cpu["nll"], cpu32["nll"], worst)
    rec["token_nll"] = dict(worst)
    nll_noise = (cpu32["nll"] - cpu["nll"]).abs().mean().item()
    worst = {"max_ratio": 0.0, "mean_ratio": 0.0}
    for i, (a, e, f) in enumerate(zip(card["raw"], cpu["raw"], cpu32["raw"])):
        hold_to_noise(torch, f"gradient leaf {i}", a, e, f, worst)
    rec["gradients"] = worst
    grad_noise = math.sqrt(sum(float(((f.float() - e.float()) ** 2).sum())
                               for e, f in zip(cpu["raw"], cpu32["raw"])))
    for key, noise in (("loss", nll_noise), ("grad_norm", grad_noise)):
        diff = abs(card[key] - cpu[key])
        rec[key] = {"card": card[key], "cpu_bf16": cpu[key], "cpu_f32": cpu32[key],
                    "bound": 2 * noise}
        check(diff <= 2 * noise, f"train step {key}: card vs CPU {diff:.4g}, over twice "
              f"the bf16 noise {noise:.4g}")
    for run in runs.values():
        del run["raw"]
    cpu32["params"] = _tree_map(cpu32["params"], lambda t: t.to("cuda"))
    cpu32["grads"] = [g.to("cuda") for g in cpu32["grads"]]
    lr = torch.tensor(3e-4)
    for opt_name in ("adamw", "adamw8bit", "adafactor"):
        opt = make_optimizer(opt_name)
        new = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            params = _tree_map(run["params"], lambda t: t.clone())
            state = opt.init(params)
            state = opt.apply(tree.unflatten(params, run["grads"]), state, params, lr)
            new[name] = (tree.leaves(params), tree.leaves(state.inner))
            torch.cuda.synchronize()
            times[name][f"{opt_name}_s"] = time.perf_counter() - t0
        worst = {"max_ratio": 0.0, "mean_ratio": 0.0}
        for i, (a, e, f) in enumerate(zip(*(new[n][0] for n in ("card", "cpu", "cpu32")))):
            hold_to_noise(torch, f"{opt_name} updated leaf {i}", a, e, f, worst)
        if opt_name == "adamw8bit":
            codes = [[t for t in new[n][1] if t.dtype == torch.int8] for n in new]
            total = sum(t.numel() for t in codes[0])
            card_off = sum(int((a != e.to(a.device)).sum()) for a, e in zip(codes[0], codes[1]))
            noise_off = sum(int((f != e.to(f.device)).sum()) for f, e in zip(codes[2], codes[1]))
            worst["codes"] = {"n": total, "card_vs_cpu_differ": card_off,
                              "cpu_bf16_vs_f32_differ": noise_off}
            check(card_off <= 2 * noise_off, f"adamw8bit codes: {card_off} of {total} differ "
                  f"card vs CPU, over twice the {noise_off} between bf16 and float32")
        rec[opt_name] = worst
        del new
    rec["times_s"] = times
    emit(rec)
    del runs, params16
    torch.cuda.empty_cache()


def train_paths(torch, gpu) -> None:
    """Phase 9: the training path on the card (no TPU kernel lies on it)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    train_card_vs_cpu(torch, gpu)
    train_llama(torch, gpu)
    train_mamba_resume(torch, gpu)


# --------------------------------------------------------------- phase 10
def event_ms(torch, fn, iters: int = 3) -> float:
    """Median device ms of ``fn`` by CUDA events (no L2 flush: the calls
    move gigabytes)."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def train_history(torch, arch, tag: str, root, steps: int, batch: int, mesh=None,
                  data_only: bool = False):
    """A Trainer run of ``steps`` steps (adamw at lr 3e-4, no checkpoints)
    at ``batch`` x TRAIN_SEQ on the card: unsharded, or on ``mesh`` under the
    FSDP mapping (``data_only``, ``set_mesh(mesh, data_only=True)``) or the
    TP one (``set_mesh(mesh)``) -> (history, wall s, peak bytes)."""
    import gc

    from repro_torch.distributed import sharding as sh
    from repro_torch.train import TrainConfig

    tc = TrainConfig(lr=3e-4, warmup=max(steps // 10, 1), total_steps=steps,
                     ckpt_every=0, ckpt_dir=str(Path(root) / tag))
    with sh.use_mesh(mesh, data_only) if mesh is not None else contextlib.nullcontext():
        trainer, _, wall, peak, _ = trainer_run(torch, arch, tc, batch, mesh=mesh)
    out = (trainer.history, wall, peak)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hold_steps(ref, got, what: str) -> list:
    """Each step's loss and grad norm of ``got`` within MESH_TRAIN_RTOL of
    ``ref``'s -> the rows of the report."""
    rows = []
    for a, b in zip(ref, got):
        rows.append({"step": a["step"], "loss": [a["loss"], b["loss"]],
                     "grad_norm": [a["grad_norm"], b["grad_norm"]], "s": [a["sec"], b["sec"]]})
        for k in ("loss", "grad_norm"):
            check(math.isfinite(b[k]) and abs(b[k] - a[k]) <= MESH_TRAIN_RTOL * abs(a[k]),
                  f"{what} step {a['step']}: {k} {b[k]} against the unsharded {a[k]}")
    check(len(got) == len(ref), f"{what} took {len(got)} steps, expected {len(ref)}")
    return rows


def steps_report(rows, ref, got) -> dict:
    (ph, p_wall, p_peak), (mh, m_wall, m_peak) = ref, got
    return {"steps": rows,
            "bit_equal": all(r["loss"][0] == r["loss"][1] and
                             r["grad_norm"][0] == r["grad_norm"][1] for r in rows),
            "step_s_after_first": [sorted(h["sec"] for h in ph[1:]),
                                   sorted(h["sec"] for h in mh[1:])],
            "wall_s": [p_wall, m_wall], "peak_mem_gb": [p_peak / 1e9, m_peak / 1e9],
            "rtol": MESH_TRAIN_RTOL}


def mesh_train(torch, gpu, mesh, root):
    """(a) Full llama3.2-3b, MESH_TRAIN_STEPS steps at the launcher's batch
    8 x 512 (adamw, no checkpoints), through a Trainer on a 1 x 1 mesh over
    NCCL under the FSDP mapping (``set_mesh(mesh, data_only=True)``), each
    step's loss and grad norm held against the unsharded Trainer's on this
    card (same config, seed, data and deterministic kernels).  Returns the
    unsharded run (phase 11 holds the TP launcher to it)."""
    from repro_torch.configs import get_config

    arch = get_config("llama3.2-3b")
    plain = train_history(torch, arch, "plain", root, MESH_TRAIN_STEPS, TRAIN_BATCH)
    fsdp = train_history(torch, arch, "fsdp", root, MESH_TRAIN_STEPS, TRAIN_BATCH, mesh,
                         data_only=True)
    rows = hold_steps(plain[0], fsdp[0], "FSDP mesh train")
    emit({"phase": "mesh_train", "model": "llama3.2-3b (28 layers, full width)",
          "mesh": "1 x 1 (data, model), NCCL", "mapping": "FSDP (set_mesh(mesh, "
          "data_only=True))", "entry": "train.Trainer(mesh=)", "optimizer": arch.optimizer,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "order": "[unsharded Trainer, FSDP Trainer]",
          **steps_report(rows, plain, fsdp), "gpu": gpu})
    return plain


class _CpuAxis:
    """A ("data",) mesh of one rank over a gloo group: the same collectives
    on the CPU beside the card's NCCL ones."""

    def __init__(self, group):
        self.group = group

    def get_group(self, axis):
        return self.group


def mesh_collectives(torch, gpu, mesh) -> None:
    """(b) compressed_grad_reduce over llama3.2-3b's largest gradient leaves
    (f32) on the 1 x 1 mesh over NCCL, against the same function on the CPU
    over gloo: the int8 payloads and scales bit for bit, the mean and the
    error state within MESH_COLL_RTOL of the mean's largest magnitude."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as col

    shapes = {"embed": (128256, 3072), "unembed": (3072, 128256), "blocks/wo": (28, 3072, 3072),
              "final_norm": (3072,), "tiny": (7, 9)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = {k: torch.randn(s, generator=gen, device="cuda") * 1e-3 for k, s in shapes.items()}
    err = col.init_error_state(grads)
    t0 = time.perf_counter()
    red, new = col.compressed_grad_reduce(grads, err, mesh)
    torch.cuda.synchronize()
    card_wall = time.perf_counter() - t0
    card_ms = event_ms(torch, lambda: col.compressed_grad_reduce(grads, err, mesh))
    cpu_grads = {k: g.cpu() for k, g in grads.items()}
    cpu_err = col.init_error_state(cpu_grads)
    cpu = _CpuAxis(dist.new_group([0], backend="gloo"))
    t0 = time.perf_counter()
    cred, cnew = col.compressed_grad_reduce(cpu_grads, cpu_err, cpu)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    payload_bytes = 0
    for k, g in grads.items():
        if g.numel() >= col._CHUNK:
            q, sc = col._quantize_chunks(g.reshape(-1), 1)
            cq, csc = col._quantize_chunks(cpu_grads[k].reshape(-1), 1)
            check(torch.equal(q.cpu(), cq) and torch.equal(sc.cpu(), csc),
                  f"compressed_grad_reduce {k}: card and CPU int8 payloads differ")
            payload_bytes += q.numel() + 4 * sc.numel()
        scale = float(cred[k].abs().max())
        for got, exp in ((red[k], cred[k]), (new[k]["e1"], cnew[k]["e1"]),
                         (new[k]["e2"], cnew[k]["e2"])):
            d = float((got.cpu() - exp).abs().max())
            worst = max(worst, d / max(scale, 1e-30))
            check(d <= MESH_COLL_RTOL * scale, f"compressed_grad_reduce {k}: card vs CPU {d}")
    n = sum(g.numel() for g in grads.values())
    emit({"phase": "mesh_collectives", "leaves": {k: list(s) for k, s in shapes.items()},
          "elements": n, "mesh": "1 x 1 over NCCL; the CPU over gloo",
          "payloads_bit_equal": True, "max_rel_diff": worst, "rtol": MESH_COLL_RTOL,
          "card_ms": card_ms, "card_first_call_s": card_wall, "cpu_s": cpu_s,
          "wire_bytes_int8": payload_bytes, "wire_bytes_f32": 4 * n, "gpu": gpu})


def mesh_moe(torch, gpu, mesh) -> None:
    """(c) moe_ffn's all-to-all dispatch at mixtral-8x22b's widths (D 6144,
    F 16384, 8 experts, top-2, bf16) on the 1 x 1 mesh, bit-equal to the
    replicated dispatch."""
    from repro_torch.models import moe

    d, f, e = 6144, 16384, 8
    params = moe.init_moe_params(torch.Generator(device="cuda").manual_seed(0), d, f, e,
                                 torch.bfloat16)
    x = torch.randn(8, 128, d, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    a = moe.moe_ffn(x, params, top_k=2)
    b = moe.moe_ffn(x, params, top_k=2, dispatch="alltoall", mesh=mesh)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "moe_ffn alltoall differs from replicated on a 1 x 1 mesh")
    ms = [event_ms(torch, lambda: moe.moe_ffn(x, params, top_k=2)),
          event_ms(torch, lambda: moe.moe_ffn(x, params, top_k=2, dispatch="alltoall",
                                              mesh=mesh))]
    cap = int(max(1, (x.shape[0] * x.shape[1] * 2 * 1.25) // e))
    emit({"phase": "mesh_moe", "widths": {"d_model": d, "d_ff": f, "experts": e, "top_k": 2},
          "tokens": x.shape[0] * x.shape[1], "capacity": cap, "dtype": "bfloat16",
          "bit_equal": True, "ms": ms, "order": "[replicated, alltoall]",
          "all_to_all_bytes": 2 * e * cap * d * 2, "gpu": gpu})
    del params


def mesh_pipeline(torch, gpu) -> None:
    """(d) A one-stage pipeline_apply at width 3072 over a ("pod",) mesh of
    one rank, bit-equal to applying the stage to each microbatch."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1,), ("pod",), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    w = (torch.randn(1, 3072, 3072, generator=gen, device="cuda") / 3072 ** 0.5).to(
        torch.bfloat16)
    x = torch.randn(4, 8, 3072, generator=gen, device="cuda").to(torch.bfloat16)

    def stage(p, mb):
        return torch.tanh(mb @ p)

    got = pipeline_apply(stage, w, x, mesh, axis="pod")
    exp = torch.stack([stage(w[0], mb) for mb in x])
    check(torch.equal(got, exp), "one-stage pipeline_apply differs from the stage applied")
    emit({"phase": "mesh_pipeline", "stages": 1, "microbatches": 4, "width": 3072,
          "bit_equal": True, "ms": event_ms(torch, lambda: pipeline_apply(stage, w, x, mesh)),
          "gpu": gpu})


def mesh_restore(torch, gpu, mesh) -> None:
    """(e) llama3.2-3b cut to 2 layers at full width: its params placed on
    the 1 x 1 mesh (every block the tensor itself, every gather too), saved
    host-gathered, restored with ``shardings=``: bit-equal, on the card."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.models import transformer as model_lib
    from repro_torch.optim import tree

    arch = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    params = model_lib.init_params(arch, torch.Generator(device="cuda").manual_seed(0))
    local = reshard_state(params, mesh)
    leaves = tree.leaves(local)
    aliased = sum(a is b for a, b in zip(leaves, tree.leaves(params)))
    gathered = sum(sh.gather(t, t._mesh_sharding) is t for t in leaves)
    check(aliased == gathered == len(leaves),
          f"world size 1: {aliased} blocks and {gathered} gathers of {len(leaves)} alias")
    shardings = sh.tree_shardings(params, mesh)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as root:
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(1, local)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = mgr.restore(1, target=local, shardings=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    for a, b in zip(tree.leaves(restored), leaves):
        check(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b),
              "restore(shardings=) on the 1 x 1 mesh differs from the saved params")
    emit({"phase": "mesh_restore", "model": "llama3.2-3b (2 of 28 layers, full width)",
          "leaves": len(leaves), "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "blocks_aliased": aliased, "gathers_aliased": gathered, "bit_equal": True,
          "save_s": save_s, "restore_s": restore_s, "gpu": gpu})


def mesh_paths(torch, gpu) -> None:
    """Phase 10: the multi-device modules over a real NCCL process group of
    world size 1 (one card; NCCL refuses two ranks on one GPU)."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    joined = init_distributed("cuda", timeout=datetime.timedelta(minutes=5))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 10 needs an NCCL group of one rank, got {dist.get_backend()}")
        mesh = make_test_mesh(1, 1, device="cuda")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
            plain = mesh_train(torch, gpu, mesh, root)
        mesh_collectives(torch, gpu, mesh)
        mesh_moe(torch, gpu, mesh)
        mesh_pipeline(torch, gpu)
        mesh_restore(torch, gpu, mesh)
    finally:
        if joined:
            dist.destroy_process_group()
    emit({"phase": "mesh_total", "s": time.perf_counter() - t0, "gpu": gpu})
    torch.cuda.empty_cache()
    return plain


def tp_train_llama(torch, gpu, plain, root) -> None:
    """(a) Full llama3.2-3b through the launcher on a 1 x 1 mesh over NCCL
    (``--mesh-data 1 --mesh-model 1``, which installs the TP mapping,
    ``set_mesh(mesh)``), MESH_TRAIN_STEPS steps at 8 x 512, each step's loss
    and grad norm held against phase 10's unsharded Trainer."""
    import gc

    from repro_torch.launch import train as tlaunch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report, trainer = tlaunch.run([
        "--arch", "llama3.2-3b", "--steps", str(MESH_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--mesh-data", "1", "--mesh-model", "1",
        "--ckpt-every", "0", "--ckpt-dir", str(Path(root) / "tp")])
    tp = (trainer.history, time.perf_counter() - t0, torch.cuda.max_memory_allocated())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    rows = hold_steps(plain[0], tp[0], "TP launcher train")
    check(report["steps"] == MESH_TRAIN_STEPS, f"the launcher took {report['steps']} steps")
    emit({"phase": "tp_train", "model": "llama3.2-3b (28 layers, full width)",
          "mesh": "1 x 1 (data, model), NCCL", "mapping": "TP (set_mesh(mesh), installed by "
          "the launcher)", "entry": "repro_torch.launch.train --mesh-data 1 --mesh-model 1",
          "optimizer": "adamw", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "order": "[unsharded Trainer (phase 10), TP launcher]",
          **steps_report(rows, plain, tp), "gpu": gpu})


def tp_train_moe(torch, gpu, mesh, root) -> None:
    """(b) mixtral-8x22b cut to TP_MOE_LAYERS layer(s) at full width (d_model
    6144, 48 heads, 8 experts of d_ff 16384, top-2, adamw, remat "full"),
    TP_MOE_STEPS steps at TP_MOE_BATCH x TRAIN_SEQ: through a Trainer on the
    1 x 1 mesh under the TP mapping (the first MoE training on a mesh),
    held against the unsharded Trainer's steps; the mesh run's peak memory
    and the share of top-k assignments dropped at capacity (counted on the
    card around ``_positions_in_expert``, recomputed forwards included)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    arch = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=TP_MOE_LAYERS)
    plain = train_history(torch, arch, "moe_plain", root, TP_MOE_STEPS, TP_MOE_BATCH)
    real = moe_mod._positions_in_expert
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")

    def counted(eids, n_experts):
        pos = real(eids, n_experts)
        cap = int(max(1, (pos.numel() * arch.capacity_factor) // n_experts))
        counts[0].add_((pos >= cap).sum())
        counts[1].add_(pos.numel())
        return pos

    moe_mod._positions_in_expert = counted
    try:
        tp = train_history(torch, arch, "moe_tp", root, TP_MOE_STEPS, TP_MOE_BATCH, mesh)
    finally:
        moe_mod._positions_in_expert = real
    rows = hold_steps(plain[0], tp[0], "mixtral TP train")
    dropped, assigned = counts.tolist()
    check(assigned > 0, "the TP MoE run routed no token")
    emit({"phase": "tp_train_moe", "model": f"mixtral-8x22b ({TP_MOE_LAYERS} of 56 layers, "
          "full width: d_model 6144, 48 heads of 128, 8 experts of d_ff 16384, top-2)",
          "mesh": "1 x 1 (data, model), NCCL", "mapping": "TP (set_mesh(mesh))",
          "entry": "train.Trainer(mesh=)", "optimizer": arch.optimizer, "remat": arch.remat,
          "batch": TP_MOE_BATCH, "seq": TRAIN_SEQ, "order": "[unsharded Trainer, TP Trainer]",
          **steps_report(rows, plain, tp), "dropped_assignments": dropped,
          "assignments": assigned, "dropped_share": dropped / assigned, "gpu": gpu})


def tp_waves(torch, gpu, mesh, plain_run) -> None:
    """(c) zamba2-7b cut to TP_WAVE_LAYERS layers at full width (w8, kv8:
    mqa_decode on the path) through ``Server(mesh=)`` on the 1 x 1 mesh
    under the TP mapping, 8 greedy requests of WAVE_PROMPT tokens and
    WAVE_NEW new ones: streams equal to the no-mesh Server's
    (``plain_run``, the same seed), bit for bit; tokens/s of both."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=TP_WAVE_LAYERS)
    streams, stats, peak, wall, srv = waves_run(torch, 0, cfg, WAVE_REQUESTS, WAVE_PROMPT,
                                                WAVE_NEW, mesh=mesh)
    del srv
    torch.cuda.empty_cache()
    p_streams, p_stats, p_peak, p_wall = plain_run
    check(streams == p_streams, "Server(mesh=) on a 1 x 1 mesh: streams differ from the "
          "no-mesh Server's")
    emit({"phase": "tp_waves", "model": f"zamba2-7b ({TP_WAVE_LAYERS} of 81 layers, full "
          "width)", "mesh": "1 x 1 (data, model), NCCL", "mapping": "TP (Server(mesh=))",
          "requests": WAVE_REQUESTS, "prompt": WAVE_PROMPT, "new_tokens": WAVE_NEW,
          "w_bits": cfg.serve_w_bits, "kv_bits": cfg.serve_kv_bits, "identical_streams": True,
          "order": "[no mesh, mesh]",
          "decode_tok_per_s": [p_stats.tokens_out / p_stats.decode_s,
                               stats.tokens_out / stats.decode_s],
          "decode_step_ms": [p_stats.decode_s / p_stats.decode_steps * 1e3,
                             stats.decode_s / stats.decode_steps * 1e3],
          "prefill_s": [p_stats.prefill_s, stats.prefill_s], "wall_s": [p_wall, wall],
          "peak_mem_gb": [p_peak / 1e9, peak / 1e9], "gpu": gpu})


def tp_paths(torch, gpu, plain_train, plain_waves) -> None:
    """Phase 11: the tensor-parallel mapping over a real NCCL process group
    of world size 1: (a) the launcher, (b) MoE training, (c) Server(mesh=)."""
    import datetime
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    joined = init_distributed("cuda", timeout=datetime.timedelta(minutes=5))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 11 needs an NCCL group of one rank, got {dist.get_backend()}")
        mesh = make_test_mesh(1, 1, device="cuda")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as root:
            tp_train_llama(torch, gpu, plain_train, root)
            tp_train_moe(torch, gpu, mesh, root)
        tp_waves(torch, gpu, mesh, plain_waves)
    finally:
        if joined:
            dist.destroy_process_group()
    emit({"phase": "tp_total", "s": time.perf_counter() - t0, "gpu": gpu})
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 12
def contract_cases(torch, gpu, summary) -> None:
    """(a) Each phase-2 case of the CF matmul (its bf16 and its f32
    activations) and of mqa_decode once more
    through its meta contract: the kernel's operator
    (``torch.ops.repro_torch``, ``kernels/ops.py``) on meta tensors of the
    case's shapes and dtypes returns the kernel's output shape and dtype
    (those of the launch in phase 2) and launches nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mpmm import mpmm_cuda
    from repro_torch.kernels.mqa_decode import mqa_decode_cuda

    kernel_ops = getattr(torch.ops, ops.NAMESPACE)
    counts = {}
    for name, op, fn, attr in (
            ("mpmm_dequant", kernel_ops.mpmm, mpmm_cuda, "launches"),
            ("mpmm_dequant_x32", kernel_ops.mpmm, mpmm_cuda, "x32_launches"),
            ("mqa_decode", kernel_ops.mqa_decode, mqa_decode_cuda, "launches")):
        before = getattr(fn, attr)
        cases = summary[name]["contract_cases"]
        for specs, kwargs, shape, dtype in cases:
            out = op(*(torch.empty(sh, dtype=dt, device="meta") for sh, dt in specs), **kwargs)
            check(out.is_meta and tuple(out.shape) == shape and out.dtype == dtype,
                  f"{name} contract on {specs}: {tuple(out.shape)} {out.dtype}, the kernel "
                  f"gave {shape} {dtype}")
        check(getattr(fn, attr) == before, f"{name}'s meta contract launched the kernel")
        counts[name] = len(cases)
    emit({"phase": "dryrun_contracts", "what": "each phase-2 case through its kernel's "
          "meta contract: the kernel's output shape and dtype, no launch",
          "cases": counts, "gpu": gpu})


def card_cell(torch, arch, shape, mesh) -> dict:
    """A dry-run cell's program on the card: ``dryrun.build_cell`` on
    ``mesh`` (world size 1) with real tensors (params drawn from seed 0,
    placed by ``reshard_state``), once under the cost count and once more
    timed, eagerly: the cost count is a dispatch mode, which a replay of a
    captured step would bypass (the mesh train step is not captured; the
    static-wave decode step of a Server would be).  Memory is the card's
    above what was allocated before the placement; ``finite``: every float
    of the timed run's output is finite."""
    import gc

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.serve import graphs

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    try:
        cell = dryrun.build_cell(arch, shape, mesh, device="cuda")
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        with graphs.disable_capture():
            rec = dryrun.trace_cell(cell, mesh)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            t0 = time.perf_counter()
            out = cell.run()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(t).all()) for t in
                     torch.utils._pytree.tree_leaves(out)
                     if torch.is_tensor(t) and t.is_floating_point())
    finally:
        sh.set_mesh(None)
    return {**rec, "placed": placed, "peak": peak, "step_s": step_s, "mapping": cell.mapping,
            "finite": finite}


def dryrun_paths(torch, gpu, summary) -> dict:
    """Phase 12: the dry run (``launch/dryrun.py``) against the card.  (a)
    The meta contracts of phase 2's cases.  (b) The dry run of three
    full-width programs over a fake group of one rank, then the same
    programs on the card over an NCCL group of one rank, eagerly: llama3.2-3b's
    phase-9 train step (8 x 512, adamw, remat "full"; the FSDP mapping, as
    ``use_fsdp_mapping`` gives it) and its W4 / kv8 static-wave
    ``decode_step`` at DRYRUN_DECODE_ROWS rows against a full cache of
    DRYRUN_DECODE_CTX (the TP mapping; the CF matmul and mqa_decode
    launch), and paligemma-3b's W8 / kv8 decode_step at the same rows and
    cache (mqa_decode at head dim 256).  Held: the dry run's FLOPs equal
    the cost count of the card's run exactly; its argument bytes are within
    DRYRUN_ARG_RTOL of what the placement allocated on the card; its peak is
    within DRYRUN_PEAK_RTOL of the card's ``max_memory_allocated`` over the
    run; its outputs hold the bytes of the card's, whose every float is
    finite.  (The decode steps' caches are all zeros; phase 2 holds
    mqa_decode against its plain version at these steps' shapes and plans.)
    Reported: the roofline's bound at the H100 constants beside the
    measured time.  Returns each program's kernel calls on the card (the
    cost count's)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import init_distributed, make_mesh, make_test_mesh

    contract_cases(torch, gpu, summary)
    llama = get_config("llama3.2-3b")
    cases = {
        "train": (llama, ShapeSpec("phase 9's step", TRAIN_SEQ, TRAIN_BATCH, "train")),
        "decode": (dataclasses.replace(llama, serve_w_bits=4),
                   ShapeSpec("wave decode", DRYRUN_DECODE_CTX, DRYRUN_DECODE_ROWS, "decode")),
        "decode_d256": (get_config("paligemma-3b"),
                        ShapeSpec("wave decode", DRYRUN_DECODE_CTX, DRYRUN_DECODE_ROWS,
                                  "decode")),
    }
    models = {"train": "llama3.2-3b (28 layers, full width)",
              "decode": "llama3.2-3b (28 layers, full width), W4 / kv8",
              "decode_d256": "paligemma-3b (18 layers, full width, head dim 256), W8 / kv8"}
    with dryrun.fake_world(1):
        fake = make_mesh((1, 1), ("data", "model"), device="cpu")
        preds = {name: dryrun.dry_run(arch, shape, fake) for name, (arch, shape) in
                 cases.items()}
    joined = init_distributed("cuda", timeout=datetime.timedelta(minutes=5))
    calls = {}
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 12 needs an NCCL group of one rank, got {dist.get_backend()}")
        mesh = make_test_mesh(1, 1, device="cuda")
        for name, (arch, shape) in cases.items():
            pred, card = preds[name], card_cell(torch, arch, shape, mesh)
            terms = roofline.time_terms(pred)
            rec = {"phase": "dryrun", "program": name,
                   "model": f"{models[name]}, {shape.global_batch} x {shape.seq_len}",
                   "mapping": [pred["mapping"], card["mapping"]],
                   "order": "[dry run (meta, fake group of 1), card (NCCL, world size 1)]",
                   "flops": [pred["flops_per_device"], card["flops_per_device"]],
                   "argument_gb": [pred["argument_size_in_bytes"] / 1e9, card["placed"] / 1e9],
                   "peak_gb": [pred["peak_bytes"] / 1e9, card["peak"] / 1e9],
                   "hbm_bytes": [pred["bytes_per_device"], card["bytes_per_device"]],
                   "kernel_calls": [pred["kernel_calls"], card["kernel_calls"]],
                   "trace_s": pred["trace_s"], "bound_s": terms["t_bound_s"],
                   "dominant": terms["dominant"], "t_compute_s": terms["t_compute_s"],
                   "t_memory_s": terms["t_memory_s"], "step_s": card["step_s"],
                   "bound_over_step": terms["t_bound_s"] / card["step_s"], "gpu": gpu}
            emit(rec)
            check(pred["mapping"] == card["mapping"], f"{name}: mappings differ")
            check(card["finite"], f"{name}: the card's run gave a value that is not finite")
            check(pred["output_size_in_bytes"] == card["output_size_in_bytes"],
                  f"{name}: the dry run's outputs hold {pred['output_size_in_bytes']} bytes, "
                  f"the card's {card['output_size_in_bytes']}")
            check(pred["flops_per_device"] == card["flops_per_device"],
                  f"{name}: the dry run counts {pred['flops_per_device']} FLOPs, the card's "
                  f"run {card['flops_per_device']}")
            check(abs(pred["argument_size_in_bytes"] - card["placed"])
                  <= DRYRUN_ARG_RTOL * card["placed"],
                  f"{name}: argument bytes {pred['argument_size_in_bytes']} against "
                  f"{card['placed']} placed on the card")
            check(abs(pred["peak_bytes"] - card["peak"]) <= DRYRUN_PEAK_RTOL * card["peak"],
                  f"{name}: predicted peak {pred['peak_bytes']} against the card's "
                  f"{card['peak']}")
            calls[name] = card["kernel_calls"]
    finally:
        if joined:
            dist.destroy_process_group()
    return calls


# --------------------------------------------------------------- phase 13
def example_paths(torch, gpu) -> None:
    """Phase 13: the port's three examples on the card, as a user runs them
    (``python -m repro_torch.examples.<name>``, here their ``main``), each
    keeping its own assertions; their printed text goes into the record."""
    import io
    import shutil
    import tempfile

    from repro_torch.examples import quickstart, serve_quantized, train_lm

    def run(example, argv):
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            out = example.main(argv)
        return out, time.perf_counter() - t0, text.getvalue().splitlines()

    q, q_s, q_text = run(quickstart, ["--device", "cuda"])
    y = q["mpmm"].pop("y")
    check(q["product"] == -12345 * 23456 and q["mpmm"]["launches"] == 1
          and q["mpmm"]["rel_err"] < 0.2 and y.dtype == torch.float32
          and bool(torch.isfinite(y).all()), f"quickstart on the card: {q}")
    emit({"phase": "example_quickstart", "wall_s": q_s, "product": q["product"],
          "programs": q["programs"], "selector": q["selector"], "mpmm": q["mpmm"],
          "stdout": q_text, "gpu": gpu})
    torch.cuda.empty_cache()
    sq, sq_s, sq_text = run(serve_quantized, ["--device", "cuda"])
    check(sq["graphs"]["captured"] > 0 and sq["graphs"]["replays"] > 0,
          f"serve_quantized captured no step: {sq['graphs']}")
    emit({"phase": "example_serve_quantized", "wall_s": sq_s,
          "tokens_out": sq["tokens_out"], "mixed_precision_steps": sq["mixed_precision_steps"],
          "prefix_hit_tokens": sq["prefix_hit_tokens"], "graphs": sq["graphs"],
          "sampled": sq["sampled"], "stdout_tail": sq_text[-8:], "gpu": gpu})
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    try:
        t, t_s, t_text = run(train_lm, ["--device", "cuda", "--steps", str(EXAMPLE_TRAIN_STEPS),
                                        "--ckpt-dir", root])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    hist = t["history"]
    after = sorted(h["sec"] for h in hist[1:])
    check(t["graphs"]["captured"] == 1 and t["graphs"]["replays"] == EXAMPLE_TRAIN_STEPS - 1,
          f"train_lm: {t['graphs']}, expected one capture and {EXAMPLE_TRAIN_STEPS - 1} replays")
    emit({"phase": "example_train_lm", "wall_s": t_s, "params": t["params"],
          "steps": len(hist), "loss_first_last": [hist[0]["loss"], hist[-1]["loss"]],
          "step_s_median_after_first": after[(len(after) - 1) // 2],
          "first_step_s": hist[0]["sec"], "graphs": t["graphs"], "stdout_tail": t_text[-3:],
          "gpu": gpu})
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 14
def pali_tp_precision(i: int) -> dict:
    """Phase 8's paligemma-3b (w, kv) cycle, every other request speculative."""
    return {**pali_precision(i), "spec_k": SPEC_K if i % 2 else 0}


def music_tp_precision(i: int) -> dict:
    """Phase 8's musicgen-medium (w, kv) cycle, every other request speculative."""
    return {**music_precision(i), "spec_k": SPEC_K if i % 2 else 0}


# phase 14's one-shot-prefill paths: (key of the unmeshed reference, arch,
# precision of request i)
PREFIX_TP_PATHS = [("paligemma", "paligemma-3b", pali_tp_precision),
                   ("musicgen", "musicgen-medium", music_tp_precision)]


def prefix_tp_run(torch, cfg, precision, capture: bool = True, mesh=None):
    """Phase 14's traffic for a one-shot-prefill arch (serve_run)."""
    return serve_run(torch, cfg, 0, TP_PREFIX_REQUESTS, TP_PREFIX_PROMPT, TP_PREFIX_NEW,
                     precision, capture, mesh=mesh)


def engine_tp_paths(torch, gpu, count, eager_twin, plain) -> dict:
    """Phase 14, the paged engine on a mesh: ``ServeEngine(mesh=)`` on a 1 x
    1 (data, model) mesh over an NCCL group of one rank, under the TP
    mapping (every group call under ``use_mesh(mesh)`` inside
    ``whole_batch()``; there every block, pool and collective is the whole
    tensor, so the streams must be the unmeshed engine's bit for bit): (a)
    full llama3.2-3b with phase 5's (w, kv) cycle, the second four requests
    speculative (``mixed_spec``); (b) mixtral-8x22b cut to TP_MOE_LAYERS
    layer(s) at full width with phase 7's precisions; (c) full paligemma-3b
    and full musicgen-medium (the one-shot prefix prefill under the mapping)
    with phase 8's (w, kv) cycles, every other request speculative
    (``PREFIX_TP_PATHS``).  Each runs captured (every captured step's key
    naming the split), then eager through ``eager_twin`` (identical streams
    and launches).  ``plain`` holds the unmeshed runs of the same traffic,
    made before the counts were set to 0.  Returns each path's launches."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    llama = get_config("llama3.2-3b")
    mixtral = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=TP_MOE_LAYERS)
    t0 = time.perf_counter()
    launches = {}
    joined = init_distributed("cuda", timeout=datetime.timedelta(minutes=5))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 14 needs an NCCL group of one rank, got {dist.get_backend()}")
        mesh = make_test_mesh(1, 1, device="cuda")

        def llama_run(capture=True):
            return engine_run(torch, 0, llama, precision=mixed_spec, capture=capture, mesh=mesh)

        def mixtral_run(capture=True):
            return serve_run(torch, mixtral, 0, 8, MIXTRAL_PROMPT, 16, mixtral_precision,
                             capture, mesh=mesh)

        def prefix_path(key, arch, precision):
            cfg = get_config(arch)

            def run(capture=True):
                return prefix_tp_run(torch, cfg, precision, capture, mesh)

            return (f"engine_tp_{key}", f"{arch} ({cfg.n_layers} layers, full width)", run,
                    plain[key], {"requests": TP_PREFIX_REQUESTS, "prefix": cfg.prefix_len,
                                 "prompt": TP_PREFIX_PROMPT, "new_tokens": TP_PREFIX_NEW,
                                 "precisions": [precision(i) for i in
                                                range(TP_PREFIX_REQUESTS)],
                                 "spec": f"spec_k {SPEC_K}, w4 draft, requests 1 and 3"})

        paths = [("engine_tp", "llama3.2-3b (28 layers, full width)", llama_run,
                  plain["llama"], {"requests": 8, "prompt": 512, "shared_prefix": 256,
                                   "new_tokens": 32, "precisions": PRECISIONS,
                                   "spec": f"spec_k {SPEC_K}, w4 draft, requests 4-7"}),
                 ("engine_tp_moe", f"mixtral-8x22b ({TP_MOE_LAYERS} of 56 layers, full width: "
                  "d_model 6144, 48 heads of 128, 8 experts of d_ff 16384, top-2)",
                  mixtral_run, plain["mixtral"], {"requests": 8, "prompt": MIXTRAL_PROMPT,
                                                  "new_tokens": 16,
                                                  "precisions": MIXTRAL_PRECISIONS}),
                 *(prefix_path(*p) for p in PREFIX_TP_PATHS)]
        for path, model, run, ref, traffic in paths:
            torch.cuda.empty_cache()
            (streams, stats, peak, wall, steps, *_), n = count(run)
            p_streams, p_stats, p_peak, p_wall, p_steps, *_ = ref
            check(streams == p_streams, f"{path}: the meshed engine's streams differ from the "
                  "unmeshed engine's")
            check(steps["captured"] > 0 and steps["replays"] > 0,
                  f"{path}: no step captured and replayed: {steps}")
            check(len(steps["splits"]) == 1 and "'tp'" in steps["splits"][0],
                  f"{path}: captured-step keys without the split: {steps['splits']}")
            check(path == "engine_tp_moe" or stats.spec_rounds > 0, f"{path}: no spec round ran")
            check(not path.startswith("engine_tp_") or path == "engine_tp_moe" or (
                stats.prefills == TP_PREFIX_REQUESTS and stats.prefill_chunks == 0),
                f"{path}: {stats.prefills} prefills, {stats.prefill_chunks} chunk calls: not "
                "the one-shot prefill alone")
            emit({"phase": path, "model": model, "mesh": "1 x 1 (data, model), NCCL",
                  "mapping": "TP, every row on every rank (ServeEngine(mesh=))", **traffic,
                  "identical_streams": True, "order": "[no mesh, mesh]",
                  "tokens_out": stats.tokens_out,
                  "decode_tok_per_s": [p_stats.decode_tok_per_s, stats.decode_tok_per_s],
                  "decode_call_ms_p50": [_p50(p_stats.decode_call_s) * 1e3,
                                         _p50(stats.decode_call_s) * 1e3],
                  "prefill_s": [p_stats.prefill_s, stats.prefill_s],
                  "spec_rounds": [p_stats.spec_rounds, stats.spec_rounds],
                  "prefix_hit_tokens": [p_stats.prefix_hit_tokens, stats.prefix_hit_tokens],
                  "wall_s": [p_wall, wall], "peak_mem_gb": [p_peak / 1e9, peak / 1e9],
                  "captured_steps": [p_steps, steps], "launches": n, "gpu": gpu})
            eager_twin(f"{path} (ServeEngine(mesh=))", path, streams, n,
                       lambda: run(capture=False))
            launches[path] = n
    finally:
        if joined:
            dist.destroy_process_group()
    emit({"phase": "engine_tp_total", "s": time.perf_counter() - t0, "gpu": gpu})
    torch.cuda.empty_cache()
    return launches


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
    spills = ptxas_report(lib_path)
    emit({"phase": "ptxas", "kernel": "paged_prefill_kernel<DP = 256, kv_bits> (bf16 q)",
          "instantiations": spills, "gpu": gpu})
    check(sorted(e["kv_bits"] for e in spills) == [4, 8, 16] and
          all("registers" in e and "spill_store_bytes" in e for e in spills),
          f"ptxas -v reports no DP = 256 paged prefill instantiations: {spills}")
    # the f32 kernels of both paged attentions: prefill at every DP, kv_bits
    # and row warps (and its merge), decode at both NC (4: D <= 128, 8: D <= 256)
    f32_prefill = ptxas_report(lib_path, "paged_prefill_f32_kernelI",
                               ("dp", "kv_bits", "row_warps"))
    f32_merge = ptxas_report(lib_path, "paged_prefill_f32_merge_kernel", ())
    f32_decode = ptxas_report(lib_path, "paged_decode_kernelIf", ("kv_bits", "nc"))
    emit({"phase": "ptxas", "kernel": "paged_prefill_f32_kernel<DP, kv_bits, R> (and its "
          "merge) and paged_decode_kernel<float, kv_bits, NC> (f32 q)", "prefill": f32_prefill,
          "prefill_merge": f32_merge, "decode": f32_decode, "gpu": gpu})
    check(len(f32_prefill) == 36 and len(f32_merge) == 1 and len(f32_decode) == 6
          and all("registers" in e and "spill_store_bytes" in e
                  for e in f32_prefill + f32_merge + f32_decode),
          f"ptxas -v reports no f32 paged instantiations: {f32_prefill} {f32_decode}")
    mqa_all = ptxas_report(lib_path, "mqa_decode_split_kernelI", ("kv_bits", "gq", "dmax"))
    wide = [e for e in mqa_all if e.get("dmax") == 256]
    emit({"phase": "ptxas", "kernel": "mqa_decode_split_kernel<kv_bits, gq, DMAX = 256> "
          "(head dims 129-256)", "instantiations": wide,
          "narrow": [e for e in mqa_all if e.get("dmax") == 128], "gpu": gpu})
    check(sorted((e["kv_bits"], e["gq"]) for e in wide) == [(4, 1), (4, 2), (8, 1), (8, 2)]
          and all("registers" in e and "spill_store_bytes" in e for e in wide),
          f"ptxas -v reports no DMAX = 256 mqa_decode instantiations: {wide}")
    x32_tc = ptxas_report(lib_path, "mpmm_x32_tc_kernelI", ("block_m", "w_bits"))
    for e in x32_tc:
        e["smem_bytes"] = _build.lib().mpmm_x32_smem_bytes(e["block_m"], e["w_bits"])
    emit({"phase": "ptxas", "kernel": "mpmm_x32_tc_kernel<BM, W_BITS> (f32 x as two TF32 "
          "terms)", "instantiations": x32_tc, "gpu": gpu})
    check(sorted((e["block_m"], e["w_bits"]) for e in x32_tc)
          == [(8, 4), (8, 8), (64, 4), (64, 8)]
          and all("registers" in e and "spill_store_bytes" in e for e in x32_tc),
          f"ptxas -v reports no f32-activation tensor-core instantiations: {x32_tc}")

    from repro_torch.configs import get_config

    llama = get_config("llama3.2-3b")
    zamba = get_config("zamba2-7b")
    timer = Timer(torch)
    summary = kernel_cases(torch, timer, gpu)
    cnn_kernel_cases(torch, timer, gpu, summary)
    x32_kernel_cases(torch, timer, gpu, summary)
    mqa_kernel_cases(torch, timer, gpu, summary)
    sampler_case(torch, timer, gpu)
    step_card_vs_cpu(torch, gpu, llama)
    hybrid_step_card_vs_cpu(torch, gpu, zamba)
    torch.cuda.empty_cache()

    # each kernel's launch count: (wrapper, attribute); the f32-activation
    # entries are counted apart from the bf16 ones of the same wrappers
    counters = {"mpmm_dequant": (mpmm_cuda, "launches"),
                "paged_decode": (paged_mqa_decode_cuda, "launches"),
                "paged_prefill": (paged_mqa_prefill_cuda, "launches"),
                "mpmm_ff_dequant": (mpmm_ff_cuda, "launches"),
                "mpmm_int": (mpmm_int_cuda, "launches"),
                "mqa_decode": (mqa_decode_cuda, "launches"),
                "mpmm_dequant_x32": (mpmm_cuda, "x32_launches"),
                "mpmm_ff_dequant_x32": (mpmm_ff_cuda, "x32_launches"),
                "paged_decode_f32": (paged_mqa_decode_cuda, "f32_launches"),
                "paged_prefill_f32": (paged_mqa_prefill_cuda, "f32_launches"),
                "paged_prefill_f32_merge": (paged_mqa_prefill_cuda, "f32_merge_launches")}

    def count(path):
        """Drive one path with every count at 0; its launches per kernel
        (and, apart, the CF matmul's launches at prefill M)."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        mpmm_cuda.prefill_m_launches = 0
        result = path()
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        launches["mpmm_dequant_prefill_m"] = mpmm_cuda.prefill_m_launches
        return result, launches

    _, cnn_launches = count(lambda: cnn_run(torch, gpu))
    emit({"phase": "cnn_launches", "launches": cnn_launches, "gpu": gpu})
    torch.cuda.empty_cache()
    def eager_twin(name, path, streams, launches, run):
        """Run a path once more with every step eager: its streams and its
        kernel launches must equal the captured run's."""
        (e_streams, e_stats, e_peak, e_wall, *_), e_launches = count(run)
        check(e_streams == streams, f"{name}: the eager streams differ from the captured ones")
        check(e_launches == launches, f"{name}: eager launches {e_launches} != captured "
              f"{launches}")
        rec = {"phase": "eager_twin", "path": name, "identical_streams": True,
               "identical_launches": True, "wall_s": e_wall, "peak_mem_gb": e_peak / 1e9,
               "gpu": gpu}
        if hasattr(e_stats, "decode_tok_per_s"):
            rec.update(decode_tok_per_s=e_stats.decode_tok_per_s,
                       decode_call_ms_p50=_p50(e_stats.decode_call_s) * 1e3)
        else:
            rec.update(decode_tok_per_s=e_stats.tokens_out / e_stats.decode_s,
                       decode_step_ms=e_stats.decode_s / e_stats.decode_steps * 1e3)
        emit(rec)
        twins[path] = rec
        return rec

    twins = {}
    (streams, stats, peak, wall, steps), launches = count(lambda: engine_run(torch, 0, llama))
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
          "peak_mem_gb": peak / 1e9, "captured_steps": steps, "launches": launches,
          "gpu": gpu})
    check(stats.tokens_out == 8 * 32, f"tokens_out {stats.tokens_out} != 256")
    check(stats.prefix_hit_tokens > 0, "no prefix-cache hits")
    check(stats.mixed_precision_steps > 0, "no mixed-precision decode steps")
    check(steps["captured"] > 0 and steps["replays"] > 0, f"no step captured and replayed: {steps}")
    streams2, stats2, _, wall2, _ = engine_run(torch, 0, llama)
    check(streams == streams2, "a second run with the same seed gave other streams")
    emit({"phase": "engine_repeat", "identical_streams": True,
          "decode_tok_per_s": stats2.decode_tok_per_s, "decode_s": stats2.decode_s,
          "decode_call_ms_p50": _p50(stats2.decode_call_s) * 1e3,
          "prefill_s": stats2.prefill_s, "wall_s": wall2,
          "ttft_ms_first": min(stats2.ttfts) * 1e3, "ttft_ms_last": max(stats2.ttfts) * 1e3,
          "gpu": gpu})
    eager_twin("greedy mixed precision", "serve", streams, launches,
               lambda: engine_run(torch, 0, llama, capture=False))

    profiles = {}
    for capture in (True, False):
        torch.cuda.empty_cache()
        profiles[("chunk", capture)] = pprof = engine_prefill_profile(torch, llama, capture)
        emit({"phase": "engine_prefill_profile", "captured": capture,
              "what": "one chunk-prefill group call of the full engine (4 x 128 tokens)",
              "profile": pprof, "gpu": gpu})
        torch.cuda.empty_cache()
        profiles[("decode", capture)] = dprof = engine_decode_profile(torch, llama, capture)
        emit({"phase": "engine_decode_profile", "captured": capture,
              "what": "one decode step of the full engine (8 rows, w8/kv8, ctx ~515)",
              "profile": dprof, "gpu": gpu})
        if dprof["busy_from"] == "profiler":
            check(dprof["paged_decode"]["launches"] >= llama.n_layers,
                  f"the profiled decode step shows {dprof['paged_decode']['launches']} paged "
                  f"decode launches, expected at least one per layer ({llama.n_layers})")

    # ---- (a) sampled: phase 5's traffic under the seeded sampler, twice
    torch.cuda.empty_cache()
    (s_streams, s_stats, _, s_wall, s_steps), sampled_launches = count(
        lambda: engine_run(torch, 0, llama, sampling=sampled))
    s_streams2, s_stats2, _, s_wall2, _ = engine_run(torch, 0, llama, sampling=sampled)
    check(s_streams == s_streams2, "two sampled runs with the same seeds gave other streams")
    off_greedy = sum(a != b for a, b in zip(s_streams, streams))
    emit({"phase": "engine_sampled", "sampling": "temperature 0.8, top_p 0.95, top_k 50 on "
          "every other request, seed = request index", "tokens_out": s_stats.tokens_out,
          "identical_streams": True, "streams_unlike_greedy": f"{off_greedy}/8",
          "decode_tok_per_s": [s_stats.decode_tok_per_s, s_stats2.decode_tok_per_s],
          "decode_call_ms_p50": [_p50(s_stats.decode_call_s) * 1e3,
                                 _p50(s_stats2.decode_call_s) * 1e3],
          "prefill_s": [s_stats.prefill_s, s_stats2.prefill_s], "wall_s": [s_wall, s_wall2],
          "captured_steps": s_steps, "launches": sampled_launches, "gpu": gpu})
    check(s_stats.tokens_out == 8 * 32, f"sampled tokens_out {s_stats.tokens_out} != 256")
    check(off_greedy > 0, "every sampled stream equals its greedy stream")
    eager_twin("sampled", "sampled", s_streams, sampled_launches,
               lambda: engine_run(torch, 0, llama, sampling=sampled, capture=False))

    # ---- (b) greedy speculation at (w8, kv8), spec_k = SPEC_K, against the
    # spec-off greedy streams of the same requests
    torch.cuda.empty_cache()
    base, b_stats, _, _, _ = engine_run(torch, 0, llama, precision=w8kv8)
    spec_launches = None
    for draft_bits in (8, 4):
        def spec_run(capture=True):
            return engine_run(torch, 0, llama, precision=w8kv8, spec_k=SPEC_K,
                              draft_bits=draft_bits, capture=capture)

        (sp, sp_stats, sp_peak, sp_wall, sp_steps), launches_db = count(spec_run)
        if draft_bits == 4:
            spec_launches = launches_db
        agree = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
                 for a, b in zip(sp, base)]
        rows = sp_stats.occupancy_sum
        emit({"phase": "engine_spec", "draft_bits": draft_bits, "w_bits": 8, "kv_bits": 8,
              "spec_k": SPEC_K, "tokens_out": sp_stats.tokens_out,
              "spec_rounds": sp_stats.spec_rounds, "spec_accept_rate": sp_stats.spec_accept_rate,
              "spec_draft_tokens": sp_stats.spec_draft_tokens,
              "spec_accepted_tokens": sp_stats.spec_accepted_tokens,
              "decode_tokens_per_row_call": (sp_stats.tokens_out - 8) / max(rows, 1),
              "streams_equal_to_spec_off": f"{sum(a == 32 for a in agree)}/8",
              "tokens_agreeing_with_spec_off": agree,
              "decode_tok_per_s": sp_stats.decode_tok_per_s,
              "spec_off_decode_tok_per_s": b_stats.decode_tok_per_s,
              "decode_call_ms_p50": _p50(sp_stats.decode_call_s) * 1e3,
              "spec_off_decode_call_ms_p50": _p50(b_stats.decode_call_s) * 1e3,
              "wall_s": sp_wall, "peak_mem_gb": sp_peak / 1e9, "captured_steps": sp_steps,
              "launches": launches_db, "gpu": gpu})
        check(sp_stats.tokens_out == 8 * 32, f"spec tokens_out {sp_stats.tokens_out} != 256")
        check(sp_stats.spec_rounds > 0, "no speculative round ran")
        if draft_bits == 8:
            check(sp_stats.spec_accept_rate >= 0.5,
                  f"a w8 draft of the w8 target accepted {sp_stats.spec_accept_rate:.3f} of "
                  "its drafts (< 0.5): bf16 noise cannot do that, a position, RoPE or page "
                  "fault would")
        eager_twin(f"greedy spec, w{draft_bits} draft", f"spec_w{draft_bits}", sp, launches_db,
                   lambda: spec_run(capture=False))

    # ---- (c) sampled speculation (temperature 0.8, draft_bits 4), twice
    torch.cuda.empty_cache()
    def spec_sampled_run(capture=True):
        return engine_run(torch, 0, llama, sampling=temperature_only, precision=w8kv8,
                          spec_k=SPEC_K, capture=capture)

    (ss, ss_stats, _, ss_wall, ss_steps), spec_sampled_launches = count(spec_sampled_run)
    ss2, ss_stats2, _, ss_wall2, _ = spec_sampled_run()
    check(ss == ss2, "two sampled spec runs with the same seeds gave other streams")
    emit({"phase": "engine_spec_sampled", "sampling": "temperature 0.8, seed = request index",
          "draft_bits": 4, "w_bits": 8, "kv_bits": 8, "spec_k": SPEC_K,
          "identical_streams": True, "tokens_out": ss_stats.tokens_out,
          "spec_rounds": ss_stats.spec_rounds, "spec_accept_rate": ss_stats.spec_accept_rate,
          "decode_tokens_per_row_call": (ss_stats.tokens_out - 8) / max(ss_stats.occupancy_sum, 1),
          "decode_tok_per_s": [ss_stats.decode_tok_per_s, ss_stats2.decode_tok_per_s],
          "wall_s": [ss_wall, ss_wall2], "captured_steps": ss_steps,
          "launches": spec_sampled_launches, "gpu": gpu})
    check(ss_stats.tokens_out == 8 * 32, f"sampled spec tokens_out {ss_stats.tokens_out} != 256")
    eager_twin("sampled spec", "spec_sampled", ss, spec_sampled_launches,
               lambda: spec_sampled_run(capture=False))

    # ---- (d) one profiled spec round, captured and eager
    for capture in (True, False):
        torch.cuda.empty_cache()
        profiles[("spec", capture)] = sp_prof = spec_round_profile(torch, llama, capture)
        emit({"phase": "engine_spec_profile", "captured": capture,
              "what": "one spec round of the full engine (8 rows, w8 target, w4 draft, kv8, "
                      f"spec_k {SPEC_K})", "profile": sp_prof, "gpu": gpu})
    sprof = profiles[("spec", True)]

    # ---- (e) float32: full llama3.2-3b with dtype="float32" (the f32
    # instantiations of both paged kernels, the f32-activation matmul),
    # mixed (w, kv), greedy and sampled, spec on requests 4-7; twice
    # captured, once eager; the same traffic in bf16 beside it
    torch.cuda.empty_cache()
    t_f32 = time.perf_counter()
    llama32 = dataclasses.replace(llama, dtype="float32")

    def f32_run(cfg, capture=True):
        return engine_run(torch, 0, cfg, sampling=mixed_sampling, precision=mixed_spec,
                          capture=capture)

    (f_streams, f_stats, f_peak, f_wall, f_steps), f32_launches = count(lambda: f32_run(llama32))
    f_streams2, f_stats2, _, f_wall2, _ = f32_run(llama32)
    check(f_streams == f_streams2, "float32: a second run with the same seeds gave other streams")
    check(f_stats.tokens_out == 8 * 32, f"float32 tokens_out {f_stats.tokens_out} != 256")
    check(f_stats.spec_rounds > 0, "float32: no speculative round ran")
    check(all(f32_launches[k] > 0 for k in ("paged_decode_f32", "paged_prefill_f32",
                                             "mpmm_dequant_x32")),
          f"float32 launches {f32_launches}: expected both f32 paged kernels and the f32 "
          "CF matmul")
    check(not any(f32_launches[k] for k in ("paged_decode", "paged_prefill", "mpmm_dequant")),
          f"float32 launches {f32_launches}: a bf16 kernel ran on the float32 path")
    eager_twin("float32 mixed, sampled, spec", "serve_f32", f_streams, f32_launches,
               lambda: f32_run(llama32, capture=False))
    torch.cuda.empty_cache()
    bf_streams, bf_stats, bf_peak, bf_wall, bf_steps = f32_run(llama)

    def f32_line(st, pk, wall, steps):
        return {"decode_tok_per_s": st.decode_tok_per_s,
                "decode_call_ms_p50": _p50(st.decode_call_s) * 1e3,
                "ttft_ms_first": min(st.ttfts) * 1e3, "ttft_ms_last": max(st.ttfts) * 1e3,
                "prefill_s": st.prefill_s, "wall_s": wall, "peak_mem_gb": pk / 1e9,
                "spec_rounds": st.spec_rounds, "spec_accept_rate": st.spec_accept_rate,
                "paged_launches_per_replay": steps["paged_launches_per_replay"],
                "captured": steps["captured"], "capture_s": steps["capture_s"]}

    emit({"phase": "engine_f32", "model": "llama3.2-3b (28 layers, full width), "
          "dtype float32", "requests": 8, "prompt": 512, "shared_prefix": 256,
          "new_tokens": 32, "precisions": PRECISIONS,
          "traffic": "greedy on even requests, sampled (temperature 0.8, top_p 0.95, top_k 50 "
                     "on every other) on odd, seed = index; spec_k 4 with a w4 draft on "
                     "requests 4-7",
          "identical_streams": True, "eager_identical": True, "tokens_out": f_stats.tokens_out,
          "float32": f32_line(f_stats, f_peak, f_wall, f_steps),
          "float32_repeat": {"decode_tok_per_s": f_stats2.decode_tok_per_s, "wall_s": f_wall2},
          "bfloat16": f32_line(bf_stats, bf_peak, bf_wall, bf_steps),
          "streams_unlike_bf16": f"{sum(a != b for a, b in zip(f_streams, bf_streams))}/8",
          "launches": f32_launches, "phase_s": time.perf_counter() - t_f32, "gpu": gpu})

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
          "captured_steps": {"captured": srv.graphs.captured, "replays": srv.graphs.replays,
                             "capture_s": srv.graphs.capture_s},
          "launches": wave_launches, "gpu": gpu})
    check(wstats.tokens_out == WAVE_REQUESTS * WAVE_NEW,
          f"waves tokens_out {wstats.tokens_out} != {WAVE_REQUESTS * WAVE_NEW}")
    for capture in (True, False):
        profiles[("wave", capture)] = wprof = waves_profile(torch, srv, zamba, WAVE_PROMPT,
                                                            capture)
        emit({"phase": "waves_profile", "captured": capture,
              "what": "two decode steps of a full wave", "profile": wprof, "gpu": gpu})
        if wprof["busy_from"] == "profiler":
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
    eager_twin("zamba2-7b waves", "waves", streams, wave_launches,
               lambda: waves_run(torch, 0, zamba, WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW,
                                 capture=False))
    torch.cuda.empty_cache()

    # ---- the ssm family: full mamba2-130m through the same waves
    mamba = get_config("mamba2-130m")
    (m_streams, mstats, mpeak, mwall, srv), mamba_launches = count(
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
    eager_twin("mamba2-130m waves", "waves_ssm", m_streams, mamba_launches,
               lambda: waves_run(torch, 0, mamba, 8, WAVE_PROMPT, WAVE_NEW, capture=False))

    # ---- phase 7: gemma3-1b, mixtral-8x22b, minitron-4b, kimi-k2
    gemma = get_config("gemma3-1b")
    step_card_vs_cpu(torch, gpu, gemma, layers=6, q_start=(1100, 1300), c=128,
                     what="step_gemma", witness_all=True)
    torch.cuda.empty_cache()

    def gemma_run(capture=True):
        return serve_run(torch, gemma, 0, 8, GEMMA_PROMPT, 16, gemma_precision, capture)

    (g_streams, g_stats, g_peak, g_wall, g_steps, _), gemma_launches = count(gemma_run)
    emit({"phase": "engine_gemma", "model": "gemma3-1b (26 layers, full width)",
          "requests": 8, "prompt": GEMMA_PROMPT, "new_tokens": 16,
          "precisions": GEMMA_PRECISIONS, "window": gemma.window,
          **serve_summary(g_stats, g_peak, g_wall, g_steps), "launches": gemma_launches,
          "gpu": gpu})
    check(g_stats.tokens_out == 8 * 16, f"gemma3-1b tokens_out {g_stats.tokens_out} != 128")
    eager_twin("gemma3-1b", "gemma", g_streams, gemma_launches, lambda: gemma_run(False))
    torch.cuda.empty_cache()

    def gemma_spec_run(capture=True):
        return serve_run(torch, gemma, 0, 4, GEMMA_PROMPT, 8, w8kv8, capture, spec_k=SPEC_K,
                         draft_bits=4)

    (gs_streams, gs_stats, gs_peak, gs_wall, gs_steps, _), gemma_spec_launches = count(
        gemma_spec_run)
    emit({"phase": "engine_gemma_spec", "model": "gemma3-1b (26 layers, full width)",
          "requests": 4, "prompt": GEMMA_PROMPT, "new_tokens": 8, "w_bits": 8,
          "draft_bits": 4, "kv_bits": 8, "spec_k": SPEC_K,
          "spec_draft_tokens": gs_stats.spec_draft_tokens,
          **serve_summary(gs_stats, gs_peak, gs_wall, gs_steps),
          "launches": gemma_spec_launches, "gpu": gpu})
    check(gs_stats.spec_rounds > 0, "gemma3-1b: no speculative round ran")
    eager_twin("gemma3-1b greedy spec, w4 draft", "gemma_spec", gs_streams, gemma_spec_launches,
               lambda: gemma_spec_run(False))
    torch.cuda.empty_cache()

    mixtral_full = get_config("mixtral-8x22b")
    step_card_vs_cpu(torch, gpu, mixtral_full, layers=2, what="step_mixtral")
    torch.cuda.empty_cache()
    mixtral = dataclasses.replace(mixtral_full, n_layers=MIXTRAL_LAYERS)
    mixtral_name = (f"mixtral-8x22b ({MIXTRAL_LAYERS} of 56 layers, full width: d_model "
                    "6144, 48 heads of 128, 8 experts of d_ff 16384, top-2)")

    def mixtral_run(capture=True, per_step=None):
        return serve_run(torch, mixtral, 0, 8, MIXTRAL_PROMPT, 16, mixtral_precision, capture,
                         per_step=per_step)

    (x_streams, x_stats, x_peak, x_wall, x_steps, _), mixtral_launches = count(mixtral_run)
    emit({"phase": "engine_mixtral", "model": mixtral_name,
          "cut": f"depth {MIXTRAL_LAYERS} of 56 layers, so that the bf16, W8 and W4 trees fit",
          "requests": 8, "prompt": MIXTRAL_PROMPT, "new_tokens": 16,
          "precisions": MIXTRAL_PRECISIONS, **serve_summary(x_stats, x_peak, x_wall, x_steps),
          "launches": mixtral_launches, "gpu": gpu})
    check(x_stats.tokens_out == 8 * 16, f"mixtral tokens_out {x_stats.tokens_out} != 128")
    eager_twin("mixtral-8x22b (4 layers)", "mixtral", x_streams, mixtral_launches,
               lambda: mixtral_run(False))
    torch.cuda.empty_cache()
    # once more, eager and instrumented (its times are not reported): the CF
    # launches inside the MoE FFNs and the assignments dropped at capacity,
    # per engine step
    read_moe, restore_moe = moe_counters(torch)
    try:
        (c_streams, *_, c_deltas), c_launches = count(lambda: mixtral_run(False, read_moe))
    finally:
        restore_moe()
    check(c_streams == x_streams and c_launches == mixtral_launches,
          "mixtral-8x22b: the instrumented run's streams or launches differ")
    x_totals = {k: sum(d[k] for d in c_deltas) for k in c_deltas[0]}
    emit({"phase": "engine_mixtral_counts", "model": mixtral_name,
          "what": "an eager run instrumented to count (times not reported): CF launches "
                  "in the step and inside the MoE FFNs, top-k assignments dropped at "
                  "capacity", "moe_totals": x_totals, "per_step": c_deltas, "gpu": gpu})
    check(x_totals["expert_cf_launches"] > 0, "no expert product ran through the CF kernel")
    torch.cuda.empty_cache()

    minitron = get_config("minitron-4b")

    def minitron_run(capture=True):
        return serve_run(torch, minitron, 0, 2, 256, 8, w8kv8, capture)

    (n_streams, n_stats, n_peak, n_wall, n_steps, _), minitron_launches = count(minitron_run)
    emit({"phase": "engine_minitron", "model": "minitron-4b (32 layers, full width)",
          "requests": 2, "prompt": 256, "new_tokens": 8, "w_bits": 8, "kv_bits": 8,
          **serve_summary(n_stats, n_peak, n_wall, n_steps), "launches": minitron_launches,
          "gpu": gpu})
    eager_twin("minitron-4b", "minitron", n_streams, minitron_launches,
               lambda: minitron_run(False))
    torch.cuda.empty_cache()

    kimi = get_config("kimi-k2-1t-a32b").reduced()
    (k_streams, k_stats, k_peak, k_wall, srv), kimi_launches = count(
        lambda: waves_run(torch, 0, kimi, 8, 64, 8))
    del srv
    emit({"phase": "waves_kimi",
          "what": "a path check on the card, not a measurement: first_dense and mqa_decode "
                  "in the static waves, on reduced kimi-k2-1t-a32b (d_model 128, 4 layers: "
                  "1 dense + 3 MoE of 8 experts, top-2, head_dim 32; full width does not "
                  "fit one card)", "requests": 8, "prompt": 64, "new_tokens": 8,
          "w_bits": kimi.serve_w_bits, "kv_bits": kimi.serve_kv_bits,
          "tokens_out": k_stats.tokens_out, "wall_s": k_wall, "launches": kimi_launches,
          "gpu": gpu})
    check(kimi_launches["mqa_decode"] > 0 and kimi_launches["mpmm_dequant"] > 0,
          f"kimi-k2 waves launches {kimi_launches}: expected mqa_decode and the CF matmul")
    eager_twin("kimi-k2 waves (reduced)", "kimi_waves", k_streams, kimi_launches,
               lambda: waves_run(torch, 0, kimi, 8, 64, 8, capture=False))
    torch.cuda.empty_cache()

    # ---- phase 8: the vlm and audio archs, then the paper's core on the card
    prefix_launches = prefix_paths(torch, gpu, count, eager_twin)
    isa_on_card(torch, gpu)

    # ---- phase 9: training; it launches none of the five kernels
    _, train_launches = count(lambda: train_paths(torch, gpu))
    emit({"phase": "train_launches", "launches": train_launches, "gpu": gpu})
    check(not any(train_launches.values()),
          f"the training path launched a serving kernel: {train_launches}")

    # ---- phase 10: the multi-device modules over NCCL; none of the five kernels
    plain_train, mesh_launches = count(lambda: mesh_paths(torch, gpu))
    emit({"phase": "mesh_launches", "launches": mesh_launches, "gpu": gpu})
    check(not any(mesh_launches.values()),
          f"the mesh paths launched a serving kernel: {mesh_launches}")

    # ---- phase 11: the tensor-parallel mapping over NCCL; its reference
    # (the no-mesh Server) runs before the counts are set to 0
    zamba_tp = dataclasses.replace(zamba, n_layers=TP_WAVE_LAYERS)
    *plain_waves, srv = waves_run(torch, 0, zamba_tp, WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW)
    del srv
    torch.cuda.empty_cache()
    _, tp_launches = count(lambda: tp_paths(torch, gpu, plain_train, plain_waves))
    emit({"phase": "tp_launches", "launches": tp_launches, "gpu": gpu})
    check(tp_launches["mpmm_dequant"] > 0 and tp_launches["mqa_decode"] > 0,
          f"the TP paths launched {tp_launches}: expected the CF matmul and mqa_decode "
          "(Server(mesh=))")

    # ---- phase 12: the dry run against the card
    torch.cuda.empty_cache()
    dry_calls, dry_launches = count(lambda: dryrun_paths(torch, gpu, summary))
    emit({"phase": "dryrun_launches", "launches": dry_launches, "gpu": gpu})
    check(dry_launches["mpmm_dequant"] > 0 and dry_launches["mqa_decode"] > 0,
          f"the dry-run paths launched {dry_launches}: expected the CF matmul and mqa_decode "
          "(the card's decode step)")
    check(dry_calls["decode_d256"].get("mqa_decode", 0) > 0,
          f"paligemma-3b's decode step called no mqa_decode: {dry_calls['decode_d256']}")

    # ---- phase 13: the examples on the card
    torch.cuda.empty_cache()
    _, example_launches = count(lambda: example_paths(torch, gpu))
    emit({"phase": "examples_launches", "launches": example_launches, "gpu": gpu})
    check(all(example_launches[k] > 0 for k in ("mpmm_dequant", "paged_decode",
                                                 "paged_prefill", "mpmm_dequant_x32")),
          f"the examples launched {example_launches}: expected the CF matmul and both paged "
          "kernels (serve_quantized) and the f32 CF entry (quickstart)")

    # ---- phase 14: the paged engine on a mesh over NCCL; its references (the
    # unmeshed engine on the same traffic) run before the counts are set to 0
    torch.cuda.empty_cache()
    plain_tp = {"llama": engine_run(torch, 0, llama, precision=mixed_spec),
                "mixtral": serve_run(torch, dataclasses.replace(mixtral_full,
                                                                n_layers=TP_MOE_LAYERS),
                                     0, 8, MIXTRAL_PROMPT, 16, mixtral_precision),
                **{key: prefix_tp_run(torch, get_config(arch), precision)
                   for key, arch, precision in PREFIX_TP_PATHS}}
    engine_tp_launches = engine_tp_paths(torch, gpu, count, eager_twin, plain_tp)
    del plain_tp

    # ---- captured against eager on this card, step by step and end to end
    table = {}
    for step in ("chunk", "decode", "spec", "wave"):
        c, e = profiles[(step, True)], profiles[(step, False)]
        table[step] = {"captured": {"wall_ms": c["wall_ms"], "busy_ms": c["device_busy_ms"],
                                    "busy_from": c["busy_from"], "replay_ms": c["replay_ms"],
                                    "launches_per_replay": c["launches_per_replay"]},
                       "eager": {"wall_ms": e["wall_ms"], "busy_ms": e["device_busy_ms"]}}
    emit({"phase": "capture_summary",
          "steps": table, "step_what": {"chunk": "one chunk-prefill group call (4 x 128)",
                                        "decode": "one engine decode step (8 rows, w8/kv8)",
                                        "spec": "one spec round (8 rows, w8/w4, spec_k 4)",
                                        "wave": "two zamba2-7b wave decode steps (8 rows)"},
          "decode_tok_per_s": {"serve": [stats.decode_tok_per_s,
                                         twins["serve"]["decode_tok_per_s"]],
                               "waves": [wstats.tokens_out / wstats.decode_s,
                                         twins["waves"]["decode_tok_per_s"]]},
          "peak_mem_gb": {"serve": [peak / 1e9, twins["serve"]["peak_mem_gb"]],
                          "waves": [wpeak / 1e9, twins["waves"]["peak_mem_gb"]]},
          "order": "[captured, eager]",
          "graphs_captured": {"serve": steps["captured"], "sampled": s_steps["captured"],
                              "spec_sampled": ss_steps["captured"]},
          "capture_s": {"serve": steps["capture_s"], "sampled": s_steps["capture_s"],
                        "spec_sampled": ss_steps["capture_s"]}, "gpu": gpu})

    by_path = {"serve": launches, "serve_f32": f32_launches, "sampled": sampled_launches,
               "spec": spec_launches,
               "spec_sampled": spec_sampled_launches, "cnn": cnn_launches,
               "waves": wave_launches, "waves_ssm": mamba_launches, "gemma": gemma_launches,
               "gemma_spec": gemma_spec_launches, "mixtral": mixtral_launches,
               "minitron": minitron_launches, "kimi_waves": kimi_launches,
               **prefix_launches, "train": train_launches, "mesh": mesh_launches,
               "tp": tp_launches, "dryrun": dry_launches, "examples": example_launches,
               **engine_tp_launches}
    for path in ("sampled", "spec", "spec_sampled", "gemma", "gemma_spec", "mixtral",
                 "minitron", "paligemma_spec", "engine_tp", "engine_tp_moe",
                 "engine_tp_paligemma", "engine_tp_musicgen"):
        for name in ("mpmm_dequant", "paged_decode", "paged_prefill"):
            check(by_path[path][name] > 0, f"{name} was never launched on the {path} path")
    # the one-shot prefix prefill runs plain attention; paged prefill serves
    # those archs only in spec verifies
    for path in ("paligemma", "musicgen"):
        check(by_path[path]["mpmm_dequant"] > 0 and by_path[path]["paged_decode"] > 0
              and by_path[path]["paged_prefill"] == 0,
              f"{path} launches {by_path[path]}: expected the CF matmul and paged decode, "
              "and no paged prefill")
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
            # the verify case; its launches are the profiled spec round's
            **({"verify": {**s["verify"], "launches_in_one_round": sprof["counted"][
                VERIFY_PROF[name]], "launches_spec_path": by_path["spec"][name]}}
               if "verify" in s else {}),
            # gemma3-1b's head dim 256: launches on its engine and spec paths
            **({"d256": {**s["d256"], "launches": by_path["gemma"][name],
                         "launches_spec_path": by_path["gemma_spec"][name]}}
               if "d256" in s else {}),
            # the MoE experts' products: their cases at mixtral's shapes,
            # and the launches made inside the MoE FFNs on the mixtral path
            **({"expert_call_sites": {**s["expert"], "path": "mixtral",
                                      "launches": x_totals["expert_cf_launches"]}}
               if "expert" in s else {}),
            # the vlm / audio archs' attention: paged decode at musicgen's
            # and paligemma's heads, paged prefill at paligemma's verify
            **({"g1_d64": {**s["g1_d64"], "launches": by_path["musicgen"][name]}}
               if "g1_d64" in s else {}),
            **({"g8_d256": {**s["g8_d256"], "launches": by_path["paligemma"][name],
                            "launches_spec_path": by_path["paligemma_spec"][name]}}
               if "g8_d256" in s else {}),
            **({"paligemma_verify": {**s["paligemma_verify"],
                                     "launches_spec_path": by_path["paligemma_spec"][name]}}
               if "paligemma_verify" in s else {}),
            # one rank's blocks and heads under the TP mapping (4-wide model
            # axis), and the launches on phase 11's paths
            **({"tp_blocks": {**s["tp_blocks"], "launches_tp_path": by_path["tp"][name]}}
               if "tp_blocks" in s else {}),
            **({"tp_partials": {**s["tp_partials"], "launches_tp_path": by_path["tp"][name]}}
               if "tp_partials" in s else {}),
            **({"tp_heads": {**s["tp_heads"], "launches_tp_path": by_path["tp"][name]}}
               if "tp_heads" in s else {}),
            # one rank's kv heads of llama3.2-3b on a 2-wide model axis (a
            # chunk, a verify window, a decode step), and the launches on
            # phase 14's meshed llama path
            **({"tp_kv_heads": {**s["tp_kv_heads"],
                                "launches_engine_tp_path": by_path["engine_tp"][name]}}
               if "tp_kv_heads" in s else {}),
            **({"tp_kv_heads_verify": {**s["tp_kv_heads_verify"],
                                       "launches_engine_tp_path": by_path["engine_tp"][name]}}
               if "tp_kv_heads_verify" in s else {}),
            # paligemma-3b's head dim 256 (the wide instantiation): its calls
            # in phase 12's paligemma decode step on the card (the cost
            # count's, one run)
            **({"paligemma_heads": {**s["paligemma_heads"], "calls_dryrun_d256_step":
                                    dry_calls["decode_d256"].get("mqa_decode", 0)}}
               if "paligemma_heads" in s else {}),
            # the f32 paged instantiations: their largest error beside the
            # one a q rounded to bf16 gives, the representative case's one
            # f32 pass, and their cases at the other shapes
            **({key: s[key] for key in ("bf16_q_max_abs_err", "bound_f32_ms", "shapes")
                if key in s} if name.endswith("f32") else {}),
            # the f32 CF entry at rows 3a / 3b's serving shapes, and its
            # launches in the quickstart's f32 section (phase 13)
            **({"serving": {**s["serving"],
                            "launches_examples_path": by_path["examples"][name]}}
               if "serving" in s else {}),
        })
    print(json.dumps({"kernels": kernels, "total_s": time.perf_counter() - t_start}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
