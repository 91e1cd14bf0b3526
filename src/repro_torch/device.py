"""Where the port's entry points run: the card unless the caller names another."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; a missing card
    raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU"
        )
    return dev
