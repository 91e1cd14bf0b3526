"""PaliGemma-3B — SigLIP + gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216.  The SigLIP
vision frontend is a stub (``models/frontends.py``): 256 precomputed patch
embeddings as a prefix.  Full attention -> long_500k skipped.  A copy of
``repro/configs/paligemma_3b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    prefix_len=256,
    serve_w_bits=8,
    serve_kv_bits=8,
)
