"""Modality-frontend stubs of the vlm and audio archs (port of
``repro/models/frontends.py``).

The configs describe the transformer backbone only; the frontend (SigLIP's
vision tower for paligemma-3b, EnCodec / T5 conditioning for
musicgen-medium) is a stub that supplies ``prefix_len`` precomputed patch or
frame embeddings of the right shape and dtype, prepended to the token
embeddings.  They are drawn with the port's threefry (``kernels/prng.py``)
exactly as the JAX stub draws them with ``jax.random.normal``, so both
packages feed the same prefix from the same seed.  ``prefix_spec`` is the
dry run's meta stand-in.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import prng
from repro_torch.models.layers import torch_dtype


def prefix_embeddings(cfg: ArchConfig, batch_size: int, seed: int = 0,
                      device=None) -> torch.Tensor:
    """Deterministic synthetic embeddings ``[B, prefix_len, d_model]`` on
    ``device`` (the card unless named): ``normal(fold_in(PRNGKey(seed), B))``
    over sqrt(d_model) in float32, cast to the model dtype."""
    if not cfg.prefix_len:
        raise ValueError(f"{cfg.name} has no modality frontend")
    key = prng.fold_in(prng.prng_key(seed).to(resolve_device(device)), batch_size)
    x = prng.normal(key, (batch_size, cfg.prefix_len, cfg.d_model))
    scale = torch.sqrt(torch.tensor(cfg.d_model, dtype=torch.float32, device=x.device))
    return (x / scale).to(torch_dtype(cfg.dtype))


def prefix_spec(cfg: ArchConfig, batch_size: int) -> torch.Tensor:
    """Meta stand-in of :func:`prefix_embeddings` for the dry run (no draw,
    no allocation): ``[B, prefix_len, d_model]`` in the model dtype."""
    return torch.empty((batch_size, cfg.prefix_len, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device="meta")
