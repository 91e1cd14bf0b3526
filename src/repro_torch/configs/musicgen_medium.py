"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048.  The EnCodec/T5
conditioning frontend is a stub (``models/frontends.py``): 64 precomputed
conditioning frame embeddings as a prefix.  Full attention -> long_500k
skipped.  A copy of ``repro/configs/musicgen_medium.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    head_dim=64,
    prefix_len=64,
    serve_w_bits=8,
    serve_kv_bits=8,
)
