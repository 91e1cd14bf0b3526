"""Deterministic synthetic token pipeline (port of ``repro/data/pipeline.py``).

  * **Deterministic & replayable**: batch contents are a pure function of
    (seed, step), so a restarted job regenerates exactly the batches it
    would have seen and checkpoint/restart is exact.
  * **Host-shardable**: each host materializes only its slice
    (``host_slice``); slices concatenate to the global batch regardless of
    host count.
  * **Prefetchable**: ``iterate`` runs a one-batch-ahead double buffer on a
    background thread.

The tokens are numpy draws, the JAX package's own, so they are bit-equal
to its batches: a mixture of Zipfian unigrams and an injected bigram rule
(every third token repeats its predecessor + 1), so the LM loss has
learnable structure.  The prefix embeddings of a vlm / audio arch come from
``models/frontends.py::prefix_embeddings`` with the reference's seed.
``batch_specs`` gives the dry run (``launch/dryrun.py``) meta stand-ins of
a batch.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _tokens_for(cfg: DataConfig, step: int, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of the global batch at `step`.  Each ROW is seeded
    independently by (seed, step, row), so any host-slice decomposition of
    the global batch yields identical data."""
    rows = []
    for r in range(lo, hi):
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, r]))
        ranks = rng.zipf(1.3, size=cfg.seq_len + 1).astype(np.int64)
        rows.append((ranks - 1) % cfg.vocab)
    toks = np.stack(rows)
    # inject learnable bigram structure: every third token repeats prev+1
    mask = (np.arange(cfg.seq_len + 1) % 3) == 2
    toks[:, mask[: toks.shape[1]]] = (np.roll(toks, 1, axis=1) + 1)[:, mask] % cfg.vocab
    return toks.astype(np.int32)


def make_batch(
    cfg: DataConfig,
    step: int,
    arch: Optional[ArchConfig] = None,
    host_slice: tuple[int, int] | None = None,
    device=None,
) -> dict:
    """``{"tokens", "labels"}`` int32 [rows, seq_len] on ``device`` (the
    card unless named), plus ``"prefix_emb"`` where ``arch`` has a
    frontend."""
    dev = resolve_device(device)
    lo, hi = host_slice or (0, cfg.global_batch)
    toks = torch.from_numpy(_tokens_for(cfg, step, lo, hi))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    if arch is not None and arch.prefix_len:
        from repro_torch.models.frontends import prefix_embeddings

        batch["prefix_emb"] = prefix_embeddings(arch, hi - lo, seed=cfg.seed + step,
                                                device=dev)
    return batch


def batch_specs(cfg: DataConfig, arch: Optional[ArchConfig] = None) -> dict:
    """Meta stand-ins of :func:`make_batch`'s global batch for the dry run
    (no draw, no allocation): ``tokens`` and ``labels`` int32 [global_batch,
    seq_len], the dtype ``make_batch`` gives them, plus ``prefix_emb``
    (``models/frontends.py::prefix_spec``) where ``arch`` has a frontend."""
    shape = (cfg.global_batch, cfg.seq_len)
    specs = {"tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
             "labels": torch.empty(shape, dtype=torch.int32, device="meta")}
    if arch is not None and arch.prefix_len:
        from repro_torch.models.frontends import prefix_spec

        specs["prefix_emb"] = prefix_spec(arch, cfg.global_batch)
    return specs


def iterate(
    cfg: DataConfig,
    start_step: int = 0,
    arch: Optional[ArchConfig] = None,
    host_slice: tuple[int, int] | None = None,
    prefetch: int = 2,
    device=None,
) -> Iterator[dict]:
    """Background-thread prefetching iterator (double buffering): the
    batches of steps ``start_step``, ``start_step + 1``, ... in order."""
    dev = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            q.put(make_batch(cfg, step, arch, host_slice, dev))
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
