"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers, d_model=3584, ssm_state=64; a SHARED full-attention block
(32H, kv=32) + MLP (d_ff=14336) applied every 6 SSM blocks (weights shared
across applications).  vocab=32000.  Sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    attn_every=6,
    subquadratic=True,
    serve_w_bits=8,
    serve_kv_bits=8,
)
