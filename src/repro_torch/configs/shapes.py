"""The assigned input-shape set (a copy of ``repro/configs/shapes.py``: the
same four shapes for every LM arch) and the (arch x shape) cell enumeration
with applicability rules (DESIGN.md SS6)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

Kind = Literal["train", "prefill", "decode"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Kind


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cells_for_arch(cfg) -> list[str]:
    """Which of the four shapes run for this arch.  long_500k requires
    sub-quadratic attention (SSM/hybrid/SWA); pure full-attention archs skip
    it (noted in DESIGN.md SS6).  No encoder-only archs are assigned, so all
    archs run decode shapes."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        cells.append("long_500k")
    return cells
