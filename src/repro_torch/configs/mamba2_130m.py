"""Mamba2-130M — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attention-free, ssm_state=128, vocab=50280.  Attention-free
-> long_500k runs (O(1)-state decode).  The attention kernel (mqa_decode) is
not on its path; the multi-precision matmul applies to the in/out
projections.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,       # unused by SSM math; kept for API uniformity
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    subquadratic=True,
    serve_w_bits=8,
    serve_kv_bits=8,
)
