"""Gemma3-1B — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; local layers use a
1024-token sliding window, every 6th layer is global.  SWA majority ->
long_500k runs (decode is O(S) on the global layers, O(w) on local).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    window=1024,
    local_ratio=5,
    subquadratic=True,
    serve_w_bits=4,
    serve_kv_bits=8,
    rope_theta=1000000.0,
)
