#!/usr/bin/env python3
"""Runs phase 2 of ``chip_smoke.py`` (every kernel against its plain version,
with its time, the plain version's, the library call's and the bound) from
the checkout at ROOT, and with ``cnn`` also its phase 4 (full ResNet18).
With ``x32`` phase 2 runs only its f32-activation cases
(``x32_kernel_cases``; ``x32 cnn`` adds phase 4).  With ``paged32`` it runs
only the paged f32 cases (decode and prefill on an f32 query, each with its
plan and ptxas registers), with ``paged`` the bf16 paged cases too, both from
this checkout's ``chip_smoke.py`` on ROOT's package, so that parent and
change run the same cases.
With ``decode`` it runs only this checkout's engine decode-step profile
(``chip_smoke.engine_decode_profile``: one decode step of full llama3.2-3b,
8 rows, w8/kv8; captured, or eager with ``eager``) on ROOT's package, which
also profiles a commit whose chip_smoke.py has no such phase (its package
must have captured steps, ``serve/graphs.py``).  Needs one CUDA card:

    python3 tools/smoke_phase2.py ROOT [x32 | paged | paged32] [cnn | decode [eager]] \
        > phase2.jsonl

ROOT may be another commit's checkout (``git archive`` of it into an ignored
directory), whose kernels are built into ROOT/build: run parent and change
in turns in one call to compare them on one card.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("smoke_phase2: no CUDA card is available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    decode = "decode" in sys.argv[2:]
    paged = {"paged": ("bf16", "f32"), "paged32": ("f32",)}
    paged = next((paged[a] for a in sys.argv[2:] if a in paged), None)
    here = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", (here if decode or paged else root) / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = smoke.gpu_line()
    from repro_torch.kernels import _build

    _build.lib()
    if decode:
        from repro_torch.configs import get_config

        capture = "eager" not in sys.argv[2:]
        smoke.emit({"phase": "engine_decode_profile", "root": str(root), "gpu": gpu,
                    "captured": capture,
                    "profile": smoke.engine_decode_profile(torch, get_config("llama3.2-3b"),
                                                           capture)})
        return 0
    timer = smoke.Timer(torch)
    if paged:
        summary = {name: {"max_abs_err": 0.0} for name in smoke.TPU_KERNELS}
        smoke.emit({"phase": "paged_cases", "root": str(root), "dtypes": paged, "gpu": gpu})
        smoke.paged_kernel_cases(torch, timer, gpu, summary, paged)
    elif "x32" in sys.argv[2:]:
        summary = {name: {"max_abs_err": 0.0} for name in smoke.TPU_KERNELS}
        smoke.x32_kernel_cases(torch, timer, gpu, summary)
    else:
        summary = smoke.kernel_cases(torch, timer, gpu)
        smoke.cnn_kernel_cases(torch, timer, gpu, summary)
        smoke.x32_kernel_cases(torch, timer, gpu, summary)
        smoke.mqa_kernel_cases(torch, timer, gpu, summary)
    if "cnn" in sys.argv[2:]:
        smoke.cnn_run(torch, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
