"""Llama-3.2-3B — small llama3 [hf:meta-llama/Llama-3.2-3B].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    serve_w_bits=8,
    serve_kv_bits=8,
)
