"""Kimi K2 — trillion-parameter MoE (paper-table config) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840, MoE 384
experts top-8.  First layer dense (DeepSeek-V3-style).  Training dry-runs use
Adafactor (Adam m/v for 1e12 params exceeds a 256-chip pod's HBM) and w4
serving weights (1T params must be <=4-bit to serve inside one pod).
Pure full attention -> long_500k skipped (DESIGN.md SS6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    n_experts=384,
    top_k=8,
    first_dense=1,
    serve_w_bits=4,
    serve_kv_bits=8,
    optimizer="adafactor",
    remat="full",
    rope_theta=50000.0,
)
