"""Minitron-4B — pruned Nemotron [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.  Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
    serve_w_bits=8,
    serve_kv_bits=8,
)
