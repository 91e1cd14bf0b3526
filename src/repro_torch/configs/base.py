"""ArchConfig: one dataclass describing an architecture, plus the registry
the launcher and tests resolve ``--arch <id>`` against.

A copy of ``repro/configs/base.py`` (the port imports nothing of ``repro``).
The registry lists only the archs the port serves; ``param_count`` keeps the
dense and MoE formulas and raises for the ssm/hybrid families, whose block
shapes live in the not-yet-ported SSM model.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Literal, Optional

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    first_dense: int = 0  # leading dense layers before MoE stack
    moe_dispatch: str = "replicated"  # or "alltoall"
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0  # hybrid: shared attention after every N ssm blocks
    ssm_head_p: int = 64

    # attention pattern
    window: Optional[int] = None  # sliding-window size
    local_ratio: int = 0  # gemma3-style: local_ratio local layers per 1 global

    # modality frontend stub (vlm/audio): prefix embeddings length
    prefix_len: int = 0

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # serving-side multi-precision (the paper's technique)
    serve_w_bits: int = 8
    serve_kv_bits: int = 8

    # training
    optimizer: str = "adamw"
    remat: str = "full"  # "none" | "dots" | "full"

    # long_500k applicability (sub-quadratic attention available?)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to 256 (pad logits are masked at
        sampling)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        mlp = 3 * d * f
        if self.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"param_count for the {self.family!r} family needs the SSM "
                "model, which is not ported yet (ROADMAP: other families)"
            )
        if self.n_experts:
            moe = 3 * d * f * self.n_experts + d * self.n_experts
            dense_l = attn + mlp
            moe_l = attn + moe
            return (
                self.first_dense * dense_l
                + (self.n_layers - self.first_dense) * moe_l
                + 2 * v * d
            )
        return self.n_layers * (attn + mlp) + 2 * v * d

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same family & topology, tiny dims."""
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if not self.attn_every else self.attn_every + 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            first_dense=min(self.first_dense, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_p=32,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            window=min(self.window, 64) if self.window else None,
            prefix_len=min(self.prefix_len, 8) if self.prefix_len else 0,
            remat="none",
        )


_REGISTRY: dict[str, str] = {
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "yi-9b": "repro_torch.configs.yi_9b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(_REGISTRY[name])
    return mod.CONFIG


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
