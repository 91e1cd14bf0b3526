"""Builds the CUDA kernels under ``csrc/`` into one shared library and loads it.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
bound with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Each
``.cu`` source compiles in its own ``nvcc`` process, all started together,
then one link step makes ``build/libkernels-<hash>.so`` at the repository
root.  The hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads the library already built.  A failed
build or load raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (see the csrc/*.cu signatures)
_SIGNATURES = {
    "mpmm_dequant_bf16": [_P] * 5 + [_I] * 7 + [_P],
    "mpmm_dequant_f32": [_P] * 5 + [_I] * 7 + [_P],
    "mpmm_ff_dequant_f32": [_P] * 4 + [_I] * 6 + [_P],
    "mpmm_ff_block_m": [_I] * 3,
    "mpmm_dequant_x32": [_P] * 5 + [_I] * 6 + [_P],
    "mpmm_ff_dequant_x32": [_P] * 4 + [_I] * 6 + [_P],
    "mpmm_x32_smem_bytes": [_I] * 2,
    "mpmm_int_i32": [_P] * 4 + [_I] * 7 + [_P],
    "mqa_decode": [_P] * 8 + [_I] * 9 + [_F, _P],
    "paged_decode_bf16": [_P] * 13 + [_I] * 13 + [_F, _P],
    "paged_decode_f32": [_P] * 13 + [_I] * 13 + [_F, _P],
    "paged_decode_block_warps": [_I] * 3,
    "paged_prefill_bf16": [_P] * 13 + [_I] * 11 + [_F, _P],
    "paged_prefill_f32": [_P] * 13 + [_I] * 11 + [_F, _P],
    "paged_prefill_f32_split": [_P] * 14 + [_I] * 12 + [_F, _P],
    "paged_prefill_rows_per_block": [],
    "paged_prefill_f32_row_warps": [_I],
    "paged_prefill_f32_keys_per_tile": [_I] * 3,
    "paged_prefill_smem_bytes": [_I] * 4,
}

_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # nvcc wall time of this process's build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on the machine with the card"
        )
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if no library of their hash exists; return its path."""
    global last_build_seconds
    out = BUILD_DIR / f"libkernels-{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}-{out.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text("\n".join(log))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
