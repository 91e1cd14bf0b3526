"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 300 --batch 8 --seq 512 [--reduced]

Same flags as ``repro.launch.train`` plus ``--device`` (default ``cuda``;
with no card present that raises instead of running on the CPU, so pass
``--device cpu``), for example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --device cpu --steps 6

It drives ``Trainer`` through ``run_with_restarts`` and prints the JAX
launcher's report (``arch``, ``steps``, ``first_loss``, ``final_loss``,
``mean_step_s``, ``stragglers``) plus ``device``.  ``--reduced`` also turns
remat off, as there.  A checkpoint already in ``--ckpt-dir`` is resumed
from.  ``--mesh-data > 0`` (a data x model device mesh) raises
``NotImplementedError``: the multi-device modules are not ported yet.
There are no XLA flags to set.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=0, help="0 = no mesh (single device)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.train import TrainConfig, Trainer

    if args.mesh_data:
        raise NotImplementedError(
            "--mesh-data shards the step over a device mesh; the multi-device modules "
            "are not ported yet (ROADMAP: distributed and launch tooling)")
    device = resolve_device(args.device)
    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    arch = dataclasses.replace(arch, remat="none" if args.reduced else arch.remat)

    tc = TrainConfig(
        lr=args.lr,
        warmup=max(args.steps // 10, 1),
        total_steps=args.steps,
        microbatches=args.microbatches,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
    )
    data = DataConfig(vocab=arch.vocab, seq_len=args.seq, global_batch=args.batch)
    trainer = Trainer(arch=arch, tc=tc, data=data, device=device)

    def attempt(start_step: int) -> dict:
        return trainer.run(args.steps, start_step=start_step)

    out = run_with_restarts(
        attempt,
        max_restarts=3,
        on_restart=lambda n, e: print(f"[train] restart {n} after {e!r}"),
    )
    hist = out["history"]
    report = {
        "arch": arch.name,
        "steps": len(hist),
        "first_loss": hist[0]["loss"],
        "final_loss": hist[-1]["loss"],
        "mean_step_s": sum(h["sec"] for h in hist) / max(len(hist), 1),
        "stragglers": trainer.monitor.stragglers,
        "device": str(device),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
