"""Mixtral 8x22B — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.  Sliding-window
attention (window 4096 per the assignment note) -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    n_experts=8,
    top_k=2,
    window=4096,
    subquadratic=True,
    serve_w_bits=8,
    serve_kv_bits=8,
    rope_theta=1000000.0,
)
