#!/usr/bin/env python3
"""Runs the alltoall MoE dispatch's parts of ``chip_smoke.py`` on one card:
phase 2's cases at kimi-k2-1t-a32b's shapes (the CF matmul at its W4
experts, M 1 and 13; ``mqa_decode`` at its heads, 8 x 8, D 112), then over
an NCCL group of one rank phase 11(b) (mixtral-8x22b's TP Trainer, the
replicated dispatch), 11(d) (the same with ``moe_dispatch="alltoall"``,
held bit for bit to (b)) and 11(e) (kimi-k2 through ``Server(mesh=)``,
replicated and alltoall, captured and eager).  With ``compare``, 11(e)'s
two captured decode steps side by side: both Servers built from one set of
weights, each wave served (its step captured), then the two graphs
replayed in turns (replicated, alltoall, alltoall, replicated, ...) timed
by CUDA events, and one replay of each under torch.profiler (device time
by kernel).  Prints ``chip_smoke.py``'s JSON lines, and last the seconds
each part took.  Needs one CUDA card:

    python3 tools/smoke_tp_alltoall.py [kernels | train | waves | compare ...] \
        > tp_alltoall.jsonl

With no part named, the first three run.
"""
from __future__ import annotations

import datetime
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("smoke_tp_alltoall: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    parts = sys.argv[1:] or ["kernels", "train", "waves"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = smoke.gpu_line()
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    seconds = {"build": time.perf_counter() - t0}
    if "kernels" in parts:  # phase 2, its cases at kimi-k2's shapes only
        t0 = time.perf_counter()
        smoke.MPMM_SHAPES, smoke.MIXTRAL_EXPERT_SHAPES, smoke.ZAMBA_PREFILL_SHAPES = [], [], []
        smoke.TP_BLOCK_SHAPES = {}
        smoke.MQA_CASES = [c for c in smoke.MQA_CASES if c[0].startswith("kimi-k2")]
        smoke.paged_kernel_cases = lambda *args, **kwargs: None
        timer = smoke.Timer(torch)
        summary = smoke.kernel_cases(torch, timer, gpu)
        smoke.mqa_kernel_cases(torch, timer, gpu, summary)
        smoke.emit({"phase": "kimi_kernel_cases", "mpmm_dequant": summary["mpmm_dequant"].get(
            "kimi_expert"), "mqa_decode": summary["mqa_decode"].get("kimi_heads"), "gpu": gpu})
        seconds["kernels"] = time.perf_counter() - t0
    if {"train", "waves", "compare"} & set(parts):
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed, make_test_mesh

        init_distributed("cuda", timeout=datetime.timedelta(minutes=5))
        try:
            mesh = make_test_mesh(1, 1, device="cuda")
            if "train" in parts:
                t0 = time.perf_counter()
                with tempfile.TemporaryDirectory(prefix="smoke_tp_alltoall_") as root:
                    ref = smoke.tp_train_moe(torch, gpu, mesh, root)
                    seconds["train_b"] = time.perf_counter() - t0
                    smoke.tp_train_moe_alltoall(torch, gpu, mesh, root, ref)
                    del ref
                seconds["train_b_d"] = time.perf_counter() - t0
            if "waves" in parts:
                t0 = time.perf_counter()
                smoke.tp_waves_alltoall(torch, gpu, mesh)
                seconds["waves_e"] = time.perf_counter() - t0
            if "compare" in parts:
                t0 = time.perf_counter()
                compare_steps(torch, smoke, gpu, mesh)
                seconds["compare"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    print(json.dumps({"seconds": seconds, "gpu": gpu}))
    return 0


def compare_steps(torch, smoke, gpu, mesh, pairs: int = 10) -> None:
    """11(e)'s captured decode steps, replicated against alltoall, in turns
    on one card (see the module note)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as model_lib
    from repro_torch.train.server import Request, Server

    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), n_layers=smoke.KIMI_LAYERS)
    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, smoke.KIMI_PROMPT).astype(np.int32)
               for _ in range(smoke.KIMI_REQUESTS)]
    graphs, streams = {}, {}
    for dispatch in ("replicated", "alltoall"):
        srv = Server(dataclasses.replace(cfg, moe_dispatch=dispatch), params, batch_size=8,
                     max_len=smoke.KIMI_PROMPT + smoke.KIMI_NEW + 8, device="cuda", mesh=mesh)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=smoke.KIMI_NEW)
                for i, p in enumerate(prompts)]
        srv.serve(reqs)
        streams[dispatch] = [list(r.out_tokens) for r in reqs]
        graphs[dispatch] = (srv, smoke.last_captured(srv.graphs, "wave_decode").graph)
    smoke.check(streams["replicated"] == streams["alltoall"], "kimi-k2 streams differ")
    times = {k: [] for k in graphs}
    order = ["replicated", "alltoall", "alltoall", "replicated"] * (pairs // 2)
    for k in order:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graphs[k][1].replay()
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end))
    profiles = {}
    for k, (_, graph) in graphs.items():
        def once(graph=graph):
            graph.replay()
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        once()
        profiles[k] = smoke.device_profile(torch, once, time.perf_counter() - t0,
                                           sums={"nccl": lambda name: "nccl" in name.lower()})
    smoke.emit({"phase": "compare_wave_steps", "what": "11(e)'s captured decode step (8 rows), "
                "replicated against alltoall, replayed in turns", "order": order,
                "replay_ms": times, "median_ms": {k: sorted(v)[len(v) // 2]
                                                  for k, v in times.items()},
                "profile": profiles, "gpu": gpu})


if __name__ == "__main__":
    sys.exit(main())
