"""Argument checks the kernel wrappers run before a launch."""
from __future__ import annotations

import torch


def expect(
    t, name: str, dtype: torch.dtype, shape: tuple, device: torch.device, align: int = 1
) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` whose data starts on an ``align``-byte boundary."""
    if t is None:
        raise ValueError(f"{name} is required")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor on {device}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")


def pool_dtype(kv_bits: int) -> torch.dtype:
    if kv_bits not in (4, 8, 16):
        raise ValueError(f"kv_bits must be 4, 8 or 16, got {kv_bits}")
    return torch.bfloat16 if kv_bits == 16 else torch.int8


def window_arg(window) -> int:
    """The kernels' window argument: 0 for none, else the window size."""
    if window is None:
        return 0
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return min(window, 2**31 - 1)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
