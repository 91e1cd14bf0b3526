#!/usr/bin/env python3
"""Memory and decode time of the paged engine with and without a mesh.

Full llama3.2-3b (seeded random weights) through ``ServeEngine`` with no
mesh and through ``ServeEngine(mesh=)`` on a 1 x 1 (data, model) mesh over
an NCCL group of one rank, in turns (no mesh, mesh, mesh, no mesh, captured;
then one of each eager), serving chip_smoke.py phase 14's traffic: 8
requests of 512 tokens (256 shared), 32 new, phase 5's (w, kv) cycle, the
last four speculative.  Each run prints one JSON line, in GB above the
memory the parameters hold: allocated after the W4 / W8 views and the pools
are made and the peak while making them (``quantized``,
``quantize_peak``), the peak while serving and what stays allocated after
(``run_peak``, ``after_run``), the median decode-group call in ms, decode
tokens/s, capture seconds and a hash of the streams (every run's must be
equal).  The kernels are built first.  Needs one CUDA card:

    python3 tools/engine_mesh_memory.py
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_test_mesh  # noqa: E402
from repro_torch.models import transformer as model_lib  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

GB = 1e9


def run(cfg, mesh, capture: bool) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, max_slots=8, page_size=16, prefill_chunk=128,
                      num_pages=8 * 40, device="cuda", mesh=mesh)
    for w in (4, 8, 16):
        eng.params_for(w)
    for kv in (4, 8, 16):
        eng.cache_for(kv)
    torch.cuda.synchronize()
    rec = {"mesh": mesh is not None, "captured": capture,
           "quantized": (torch.cuda.memory_allocated() - base) / GB,
           "quantize_peak": (torch.cuda.max_memory_allocated() - base) / GB}
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 256).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, 256).astype(np.int32)])
               for _ in range(8)]
    with contextlib.nullcontext() if capture else graphs.disable_capture():
        reqs = [eng.submit(prompts[i], SamplingParams(max_new_tokens=32),
                           PrecisionParams(**cs.mixed_spec(i))) for i in range(8)]
        eng.run()
    torch.cuda.synchronize()
    rec.update(run_peak=(torch.cuda.max_memory_allocated() - base) / GB,
               after_run=(torch.cuda.memory_allocated() - base) / GB,
               decode_call_ms_p50=cs._p50(eng.stats.decode_call_s) * 1e3,
               decode_tok_per_s=eng.stats.decode_tok_per_s, capture_s=eng.graphs.capture_s,
               streams=hash(tuple(tuple(r.out_tokens) for r in reqs)))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("engine_mesh_memory: no CUDA card is available", file=sys.stderr)
        return 2
    _build.build()
    _build.lib()
    init_distributed("cuda")
    mesh = make_test_mesh(1, 1, device="cuda")
    cfg = get_config("llama3.2-3b")
    for m, capture in ((None, True), (mesh, True), (mesh, True), (None, True),
                       (None, False), (mesh, False)):
        print(json.dumps(run(cfg, m, capture)), flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
