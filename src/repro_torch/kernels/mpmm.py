"""W4A16 / W8A16 dequant matmul: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/mpmm.cu``) replaces ``repro/kernels/mpmm.py::mpmm_pallas``
in dequant mode, CF order: ``x [M, K]`` bf16 times int8 ``[K, N]`` or K-packed
int4 ``[K/2, N]`` weights, f32 accumulation, the per-column f32 scale on the
f32 sum, one cast to bf16.  At decode M it is bound by the weight bytes; see
the source note for its design.  The plain version is
:func:`repro_torch.kernels.ref.mpmm_ref`, which the dispatch wrapper
(``ops.mpmm``) runs for CPU tensors and ``chip_smoke.py`` holds the kernel
against on the card.

``mpmm_cuda.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect
from repro_torch.kernels.ref import mpmm_ref

__all__ = ["mpmm_cuda", "mpmm_ref"]

_SMALL_M = 8  # rows the weight-streaming kernel takes (csrc: SM_MMAX)
_SM_COLS = 64  # columns per block of that kernel (csrc: SM_COLS)
_SM_KC = 512  # K rows it stages per chunk (csrc: SM_KC)
_TARGET_BLOCKS = 264  # two waves of the H100's 132 SMs


def split_k(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, K rows per split) for the small-M kernel: split K until the
    grid has about two blocks per SM, each split a whole number of x chunks
    (so int4 splits stay on byte rows)."""
    if m > _SMALL_M:
        return 1, k
    col_blocks = -(-n // _SM_COLS)
    splits = max(1, min(-(-_TARGET_BLOCKS // col_blocks), k // _SM_KC))
    per = -(-k // splits)
    per = -(-per // _SM_KC) * _SM_KC
    return -(-k // per), per


def mpmm_cuda(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, *, w_bits: int
) -> torch.Tensor:
    """Launch the dequant matmul on ``x``'s card: [M, K] bf16 -> [M, N] bf16."""
    if w_bits not in (4, 8):
        raise ValueError(f"mpmm kernel takes w_bits 4 or 8, got {w_bits}")
    m, k = x.shape
    n = w_data.shape[-1]
    if w_bits == 4 and k % 2:
        raise ValueError(f"int4 weights pack K in pairs; K={k} is odd")
    if n % 8:
        raise ValueError(f"mpmm kernel reads 8 columns per load; N={n} % 8 != 0")
    if not x.is_cuda:
        raise ValueError("mpmm_cuda takes CUDA tensors")
    dev = x.device
    expect(x, "x", torch.bfloat16, (m, k), dev, align=16)
    expect(w_data, "w_data", torch.int8, (k // 2 if w_bits == 4 else k, n), dev, align=16)
    expect(w_scale.reshape(-1), "w_scale", torch.float32, (n,), dev, align=16)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    splits, per = split_k(m, n, k)
    partial = (
        torch.empty((splits, m, n), dtype=torch.float32, device=dev)
        if splits > 1 else out
    )
    lib = _build.lib()
    err = lib.mpmm_dequant_bf16(
        x.data_ptr(), w_data.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        partial.data_ptr(), m, n, k, w_bits, splits, per,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "mpmm_dequant_bf16")
    mpmm_cuda.launches += 1
    return out


mpmm_cuda.launches = 0
