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
from; ``--ckpt-every 0`` writes none.  There are no XLA flags to set.

``--mesh-data D --mesh-model M`` trains on a D x M device mesh, one process
per device, under the mapping the JAX launcher installs,
``sharding.set_mesh(mesh)``: the tensor-parallel mapping
(``train/trainer.py``; the batch split over ``data``, each layer split over
``model`` where the model axis divides it), MoE archs included.  Start D*M
processes with ``torchrun``, e.g. on the CPU (gloo)::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --reduced --device cpu --mesh-data 2 --mesh-model 2

and on cards (NCCL, one card per process) without ``--device cpu``.  One
process with D*M = 1 needs no ``torchrun``.  The global batch must divide
by D.  Rank 0 prints the report and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Optional

import torch


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
    ap.add_argument("--ckpt-every", type=int, default=50, help="0 = no checkpoints")
    ap.add_argument("--mesh-data", type=int, default=0, help="0 = no mesh (single device)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(argv: Optional[list[str]] = None):
    """Parses ``argv``, trains -> (report, trainer)."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.train import TrainConfig, Trainer

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
    with _mesh(args, device) as mesh:
        if mesh is not None and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        trainer = Trainer(arch=arch, tc=tc, data=data, device=device, mesh=mesh)

        def attempt(start_step: int) -> dict:
            return trainer.run(args.steps, start_step=start_step)

        out = run_with_restarts(
            attempt,
            max_restarts=3,
            on_restart=lambda n, e: print(f"[train] restart {n} after {e!r}"),
        )
        rank = torch.distributed.get_rank() if mesh is not None else 0
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
    if rank == 0:
        print(json.dumps(report, indent=1))
    return report, trainer


@contextlib.contextmanager
def _mesh(args, device):
    """The (data, model) DeviceMesh of ``--mesh-data`` / ``--mesh-model``
    (None without ``--mesh-data``), over a process group joined here unless
    the caller joined one, installed as the JAX launcher installs it
    (``sharding.set_mesh(mesh)``) for the block; a group joined here is left
    on the way out."""
    if not args.mesh_data:
        yield None
        return
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import init_distributed, make_mesh

    n = args.mesh_data * args.mesh_model
    joined = init_distributed(device)
    try:
        if dist.get_world_size() != n:
            raise ValueError(
                f"--mesh-data {args.mesh_data} --mesh-model {args.mesh_model} needs {n} "
                f"processes, one per device (torchrun --nproc-per-node {n}); this group "
                f"has {dist.get_world_size()}")
        mesh = make_mesh((args.mesh_data, args.mesh_model), ("data", "model"), device)
        with sh.use_mesh(mesh):
            yield mesh
    finally:
        if joined:
            dist.destroy_process_group()


def main(argv: Optional[list[str]] = None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
