"""End-to-end training (port of ``examples/train_lm.py``): the JAX
example's llama-style model (8 layers of d_model 512, a 32k vocab: 65M
parameters by ``param_count``) trained on the synthetic pipeline, with
checkpoints and crash-resume, through ``run_with_restarts`` and ``Trainer``,
whose every step after the first is a replay of the captured train step on
the card (``train/trainer.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import run_with_restarts
from repro_torch.train import TrainConfig, Trainer


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # the JAX example's arch and name: 8L x d512 + 32k vocab embeddings
    arch = dataclasses.replace(
        get_config("llama3.2-3b"),
        name="llama-124m",
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=4 * args.d_model,
        vocab=32768,
        remat="none",
    )
    print(f"params ~= {arch.param_count()/1e6:.0f}M")

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    tc = TrainConfig(lr=6e-4, warmup=30, total_steps=args.steps, microbatches=1,
                     ckpt_every=100, ckpt_dir=ckpt)
    data = DataConfig(vocab=arch.vocab, seq_len=args.seq, global_batch=args.batch)
    tr = Trainer(arch=arch, tc=tc, data=data, device=dev)

    out = run_with_restarts(lambda s: tr.run(args.steps, start_step=s), max_restarts=2)
    hist = out["history"]
    for h in hist[:: max(len(hist) // 15, 1)]:
        flag = " STRAGGLER" if h["straggler"] else ""
        print(f"step {h['step']:4d} loss {h['loss']:.4f} ({h['sec']:.2f}s){flag}")
    print(f"\nfinal loss {hist[-1]['loss']:.4f} (from {hist[0]['loss']:.4f}); "
          f"checkpoints in {ckpt}")
    assert hist[-1]["loss"] < hist[0]["loss"]
    return {"device": str(dev), "params": arch.param_count(), "history": hist,
            "graphs": {"captured": tr.graphs.captured, "replays": tr.graphs.replays,
                       "capture_s": tr.graphs.capture_s}}


if __name__ == "__main__":
    main()
