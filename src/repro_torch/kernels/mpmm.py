"""Multi-precision matmul: the CUDA kernels' wrappers and their plain versions.

Three kernels replace ``repro/kernels/mpmm.py::mpmm_pallas``:

- ``mpmm_cuda`` (``csrc/mpmm.cu``): dequant mode, CF order.  ``x [M, K]``
  bf16 times int8 ``[K, N]`` or K-packed int4 ``[K/2, N]`` weights, f32
  accumulation, the per-column f32 scale on the f32 sum, one cast to bf16
  (or, with ``out_dtype=torch.float32``, the scaled f32 sum uncast: a
  row-split partial product, summed over ``model`` before its one cast).
  :func:`launch_plan` picks its kernel, tiles and K split from the shape.
  Float32 ``x`` (the CNN path, the quickstart) takes the entry
  ``mpmm_dequant_x32`` instead, an f32 FMA kernel whose output is f32 (the
  Pallas kernel writes ``x.dtype``); :func:`x32_launch_plan` picks its K
  split.  Plain version :func:`repro_torch.kernels.ref.mpmm_ref`.
- ``mpmm_ff_cuda`` (``csrc/mpmm.cu`` too): dequant mode, FF order.  The same
  product with k outermost, K stages of 512 rows added in stage order into
  an unscaled f32 output.  On bf16 ``x`` it runs on the CF order's
  tensor-core kernel with the K split fixed at the stages and an unscaled
  f32 epilogue (``launch_plan(..., stage_k=512)``); on f32 ``x`` on the f32
  kernel with the same stages (``mpmm_ff_dequant_x32``).  Plain version
  :func:`repro_torch.kernels.ref.mpmm_ff_ref`.
- ``mpmm_int_cuda`` (``csrc/mpmm_int.cu``): int mode, CF or FF order.  int8 /
  int16 ``x`` times int4 / int8 / int16 weights, the exact int32 product mod
  2^32 through radix-256 digit planes on the 8-bit tensor cores.
  :func:`int_launch_plan` picks its K split.  Plain version
  ``ref.mpmm_ref(mode="int")``, run on CPU tensors (CUDA has no int32
  matmul).

The dispatch wrapper ``ops.mpmm`` runs the plain versions for CPU tensors;
``chip_smoke.py`` holds each kernel against its plain version.  Each
wrapper's ``launches`` counts the calls that launched its kernel (for the
dequant wrappers, on bf16 ``x``), and ``x32_launches`` the calls that
launched the f32-activation kernel.
:func:`mpmm_contract` is the CF kernel's contract on meta tensors (the dry
run): ``mpmm_cuda``'s checks and allocations (:func:`launch_buffers`),
nothing launched.  :func:`mpmm_cost` is the work of one call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect
from repro_torch.kernels.ref import FF_STAGE_K, mpmm_ref

__all__ = ["mpmm_contract", "mpmm_cuda", "mpmm_ff_cuda", "mpmm_int_cuda", "mpmm_ref"]

SMS = 132  # the H100's SMs
DECODE_M = 8  # the most rows the 8-row tile takes: the decode batch buckets
DECODE_BK = 128  # the 8-row tile's K step; its splits are whole steps (csrc: tc_bk<8>)
TC_BLOCK_M = (128, 64)  # block rows of the tensor-core kernel above DECODE_M (csrc: BM)
TC_BN = 128  # its block columns (csrc: TC_BN)
TC_BK = 64  # its K step; a split is a whole number of steps (csrc: TC_BK)
TC_MIN_STEPS = 2  # K steps a split keeps at least
TC_SPLIT_MIN_K = 512  # a shorter K is not split: the second pass would cost more
INT_TILE = 64  # block rows and columns of the int-mode kernel (csrc: IB_M, IB_N)
INT_SPLIT_MIN_K = 1024  # its CF order splits no shorter K: the second pass would cost more
X32_TILE = 64  # block rows and columns of the f32-activation kernel (csrc: X32_BM, X32_BN)
X32_BK = 16  # its K step; a split is a whole number of steps (csrc: X32_BK)
X32_SPLIT_MIN_K = 256  # K rows an f32 split keeps at least
X32_DTYPES = (torch.bfloat16, torch.float32)  # the dequant kernels' activations


def wave_fill(blocks: int, per_sm: int | None = None) -> float:
    """The share of block slots a grid fills over its waves: one block per
    SM up to ``SMS`` blocks, two per SM above (their shared memory and
    registers fit twice); with ``per_sm``, that many per SM at any size."""
    slots = SMS * per_sm if per_sm else (SMS if blocks <= SMS else 2 * SMS)
    return blocks / (-(-blocks // slots) * slots)


def even_splits(k: int, step: int, min_steps: int) -> dict[int, int]:
    """{splits: steps per split} for every split of K into whole ``step``-row
    steps of at least ``min_steps`` each, the most even of each count
    (K below ``TC_SPLIT_MIN_K`` is not split), in increasing splits."""
    steps = -(-k // step)
    opts = {1: steps}
    if k >= TC_SPLIT_MIN_K:
        for per in range(steps - 1, min_steps - 1, -1):
            opts[-(-steps // per)] = per  # a smaller per of the same count is more even
    return opts


def launch_plan(m: int, n: int, k: int, stage_k: int | None = None,
                w_bits: int | None = None) -> dict:
    """How ``mpmm_cuda`` launches an [M, K] x [K, N] product on the
    tensor-core kernel: its block rows, the K split and the grid.  With
    ``stage_k``, how ``mpmm_ff_cuda`` launches it in the FF order: any M,
    one split per ``stage_k``-row K stage, only the block rows chosen
    (by the rule below with the split fixed; the C entry point
    ``mpmm_ff_block_m`` applies the same rule).

    For the tensor-core kernel: where 128-row tiles alone give two waves of
    blocks, no split.  Otherwise every (block rows, splits) whose grid stays
    within two blocks per SM (or has no split) is scored by
    ``wave_fill`` (a grid of 120-131 blocks, one per SM, fills its wave; one
    of 144 leaves most SMs at one block while 12 run two), and the plan with
    the fewest splits within 90% of the best fill wins, 128-row tiles on a
    tie.  On the H100 this rule picked the fastest or a plan within 13% of it
    at every shape of a sweep over llama3.2-3b's projections at M 128 / 256,
    ResNet18's CF layers and zamba2-7b's in_proj (``tools/sweep_mpmm_plans.py``,
    numbers in PERF.md).

    At decode M (M <= 8, where the plan needs ``w_bits``) the tile has 8
    rows and the product is bound by the weight bytes: K is split in whole
    128-row steps until the grid fills two blocks per SM at int4, one at
    int8 (an int8 block's ring holds twice the weight bytes in flight, and
    every split adds a partial to the second pass), the fewest splits within
    90% of the best fill.  On the H100 this picked the fastest split or one
    within 10% of it at every serving shape at M 1-8
    (``tools/sweep_mpmm_plans.py decode``)."""
    col_tiles = -(-n // TC_BN)
    if stage_k is not None:
        splits = -(-k // stage_k)
        fills = {bm: wave_fill(-(-m // bm) * col_tiles * splits)
                 for bm in (TC_BLOCK_M if m > 64 else TC_BLOCK_M[-1:])}
        best = max(fills.values())
        block_m = next(bm for bm, fill in fills.items() if fill >= 0.9 * best)
        return {"kernel": "tensor_core", "block_m": block_m, "block_n": TC_BN,
                "splits": splits, "k_per_split": stage_k,
                "grid": (col_tiles, -(-m // block_m), splits)}
    if m <= DECODE_M:
        if w_bits not in (4, 8):
            raise ValueError(f"a decode-M plan takes w_bits 4 or 8, got {w_bits}")
        opts = even_splits(k, DECODE_BK, 1)
        fills = {s: wave_fill(col_tiles * s, per_sm=2 if w_bits == 4 else 1) for s in opts}
        best = max(fills.values())
        splits = min(s for s, fill in fills.items() if fill >= 0.9 * best)
        per = opts[splits] * DECODE_BK
        return {"kernel": "tensor_core", "block_m": DECODE_M, "block_n": TC_BN,
                "splits": -(-k // per), "k_per_split": per, "grid": (col_tiles, 1, splits)}
    steps = -(-k // TC_BK)
    if m > 64 and -(-m // 128) * col_tiles >= 2 * SMS:
        block_m, per = 128, steps
    else:
        cands = {}
        for bm in TC_BLOCK_M if m > 64 else TC_BLOCK_M[-1:]:
            tiles = -(-m // bm) * col_tiles
            for splits, per in even_splits(k, TC_BK, TC_MIN_STEPS).items():
                if splits > 1 and tiles * splits > 2 * SMS:
                    break  # a split only to fill the card, never past two blocks per SM
                cands[(bm, splits)] = (wave_fill(tiles * splits), per)
        best = max(fill for fill, _ in cands.values())
        block_m, splits = min((key for key, (fill, _) in cands.items() if fill >= 0.9 * best),
                              key=lambda key: (key[1], -key[0]))
        per = cands[(block_m, splits)][1]
    per *= TC_BK
    splits = -(-k // per)
    return {"kernel": "tensor_core", "block_m": block_m, "block_n": TC_BN, "splits": splits,
            "k_per_split": per, "grid": (col_tiles, -(-m // block_m), splits)}


def x32_launch_plan(m: int, n: int, k: int, stage_k: int | None = None) -> dict:
    """How the f32-activation kernel launches an [M, K] x [K, N] product:
    64 x 64 output tiles and K in ``splits`` ranges of ``k_per_split`` rows
    (the grid's z, summed in range order by a second pass).  With
    ``stage_k`` (the FF order) one range per stage.  The CF order splits K
    only where K >= ``TC_SPLIT_MIN_K`` and the tiles alone give fewer than
    two blocks per SM: into as many ranges as bring the grid to two blocks
    per SM, each a whole number of 16-row steps and at least
    ``X32_SPLIT_MIN_K`` rows."""
    tiles = -(-n // X32_TILE) * -(-m // X32_TILE)
    if stage_k is not None:
        per = stage_k
    elif k >= TC_SPLIT_MIN_K and tiles < 2 * SMS:
        want = min(-(-2 * SMS // tiles), k // X32_SPLIT_MIN_K)
        per = -(-(-(-k // want)) // X32_BK) * X32_BK
    else:
        per = -(-k // X32_BK) * X32_BK
    splits = -(-k // per)
    return {"kernel": "f32_fma", "block_m": X32_TILE, "block_n": X32_TILE, "splits": splits,
            "k_per_split": per, "grid": (-(-n // X32_TILE), -(-m // X32_TILE), splits)}


def mpmm_cost(m: int, k: int, n: int, w_bytes: int, x_bytes: int = 2, out_bytes: int = 2,
              scale: bool = True) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one [M, K] x [K, N] launch: 2·M·N·K, and x
    (``x_bytes`` an element), the ``w_bytes`` of packed weights, the f32
    column scale (where the kernel reads one) and the output (``out_bytes``
    an element) each moved once."""
    return 2 * m * n * k, m * k * x_bytes + w_bytes + 4 * n * scale + m * n * out_bytes


def _expect_dequant(x, w_data, w_bits: int, m: int, k: int, n: int) -> bool:
    """The dequant kernels' checks of x ([M, K] bf16 or f32) and the packed
    weights; True for f32 x.  The bf16 kernels copy 16 bytes at a time, the
    f32 kernel loads elements."""
    x32 = x.dtype == torch.float32
    expect(x, "x", x.dtype if x.dtype in X32_DTYPES else torch.bfloat16, (m, k), x.device,
           align=4 if x32 else 16)
    expect(w_data, "w_data", torch.int8, (k // 2 if w_bits == 4 else k, n), x.device,
           align=1 if x32 else 16)
    return x32


def launch_buffers(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, w_bits: int,
    out_dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """The CF kernels' checks on CUDA or meta tensors, then what a launch
    allocates: (out [M, N] ``out_dtype``, the f32 partials of its K split
    (``out`` itself when it has one split), its plan (:func:`launch_plan`,
    or :func:`x32_launch_plan` for f32 ``x``), or None at M = 0, where
    nothing is launched).  ``x`` is bf16 or f32; f32 ``x`` writes f32."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mpmm kernel writes bf16 or f32, got {out_dtype}")
    if w_bits not in (4, 8):
        raise ValueError(f"mpmm kernel takes w_bits 4 or 8, got {w_bits}")
    x32 = x.dtype == torch.float32
    if x32 and out_dtype != torch.float32:
        raise ValueError(f"the f32-activation kernel writes f32, got out_dtype={out_dtype}")
    m, k = x.shape
    n = w_data.shape[-1]
    if w_bits == 4 and k % 2:
        raise ValueError(f"int4 weights pack K in pairs; K={k} is odd")
    if n % 8 and not x32:
        raise ValueError(f"mpmm kernel reads 8 columns per load; N={n} % 8 != 0")
    if k == 0:
        raise ValueError("mpmm kernel needs K >= 1")
    dev = x.device
    _expect_dequant(x, w_data, w_bits, m, k, n)
    expect(w_scale.reshape(-1), "w_scale", torch.float32, (n,), dev, align=4 if x32 else 16)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out, out, None  # nothing to compute
    plan = x32_launch_plan(m, n, k) if x32 else launch_plan(m, n, k, w_bits=w_bits)
    # one split writes out directly (bf16), or its partial into out (f32)
    partial = (torch.empty((plan["splits"], m, n), dtype=torch.float32, device=dev)
               if plan["splits"] > 1 else out)
    return out, partial, plan


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    """The CF kernels' output type: ``out_dtype``, by default bf16 for bf16
    ``x`` and f32 for f32 ``x`` (the Pallas kernel writes ``x.dtype``)."""
    if out_dtype is not None:
        return out_dtype
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def mpmm_contract(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, *, w_bits: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The CF kernel on meta tensors: :func:`mpmm_cuda`'s checks and
    allocations, its output returned, nothing launched."""
    if not x.is_meta:
        raise ValueError("mpmm_contract takes meta tensors")
    return launch_buffers(x, w_data, w_scale, w_bits, _out_dtype(x, out_dtype))[0]


def mpmm_cuda(
    x: torch.Tensor, w_data: torch.Tensor, w_scale: torch.Tensor, *, w_bits: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Launch the dequant matmul on ``x``'s card: [M, K] bf16 -> [M, N]
    ``out_dtype``, bf16 (the default: the scaled sum cast once) or f32
    (uncast); [M, K] f32 -> [M, N] f32 on the f32-activation kernel."""
    if not x.is_cuda:
        raise ValueError("mpmm_cuda takes CUDA tensors")
    out_dtype = _out_dtype(x, out_dtype)
    out, partial, plan = launch_buffers(x, w_data, w_scale, w_bits, out_dtype)
    if plan is None:
        return out
    m, k = x.shape
    n = w_data.shape[-1]
    if x.dtype == torch.float32:
        err = _build.lib().mpmm_dequant_x32(
            x.data_ptr(), w_data.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            partial.data_ptr(), m, n, k, w_bits, plan["splits"], plan["k_per_split"],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "mpmm_dequant_x32")
        mpmm_cuda.x32_launches += 1
        return out
    entry = "mpmm_dequant_bf16" if out_dtype == torch.bfloat16 else "mpmm_dequant_f32"
    err = getattr(_build.lib(), entry)(
        x.data_ptr(), w_data.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        partial.data_ptr(), m, n, k, w_bits, plan["splits"], plan["k_per_split"],
        plan["block_m"], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, entry)
    mpmm_cuda.launches += 1
    mpmm_cuda.prefill_m_launches += m > DECODE_M
    return out


mpmm_cuda.launches = 0  # launches on bf16 x (either output type)
mpmm_cuda.prefill_m_launches = 0  # of them, launches at M > 8 (prefill M)
mpmm_cuda.x32_launches = 0  # launches of the f32-activation entry


def _dims(x, w_data, w_bits: int, name: str) -> tuple[int, int, int]:
    """(M, K, N) of a launch on ``x``'s card, after the checks the FF and
    int kernels share."""
    m, k = x.shape
    n = w_data.shape[-1]
    if w_bits == 4 and k % 2:
        raise ValueError(f"int4 weights pack K in pairs; K={k} is odd")
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"{name} needs M, K, N >= 1, got {(m, k, n)}")
    return m, k, n


def _stage_scratch(m, n, stages, dtype, out) -> torch.Tensor:
    """The [stages, M, N] buffer the kernels spill their K-stage partials
    to.  The kernels take it with the stage count and refuse a count that
    does not split K; one stage writes ``out`` directly and needs none."""
    if stages == 1:
        return out
    return torch.empty((stages, m, n), dtype=dtype, device=out.device)


def mpmm_ff_cuda(x: torch.Tensor, w_data: torch.Tensor, *, w_bits: int) -> torch.Tensor:
    """Launch the FF-order dequant matmul on ``x``'s card: [M, K] bf16 or
    f32 -> [M, N] f32, the unscaled sum of the 512-row K stages in stage
    order (f32 ``x`` on the f32-activation kernel)."""
    if w_bits not in (4, 8):
        raise ValueError(f"mpmm kernel takes w_bits 4 or 8, got {w_bits}")
    m, k, n = _dims(x, w_data, w_bits, "mpmm_ff_cuda")
    dev = x.device
    x32 = _expect_dequant(x, w_data, w_bits, m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    stages = -(-k // FF_STAGE_K)
    part = _stage_scratch(m, n, stages, torch.float32, out)
    entry = "mpmm_ff_dequant_x32" if x32 else "mpmm_ff_dequant_f32"
    err = getattr(_build.lib(), entry)(
        x.data_ptr(), w_data.data_ptr(), out.data_ptr(), part.data_ptr(), m, n, k, w_bits,
        FF_STAGE_K, stages, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, entry)
    if x32:
        mpmm_ff_cuda.x32_launches += 1
    else:
        mpmm_ff_cuda.launches += 1
    return out


mpmm_ff_cuda.launches = 0  # launches on bf16 x
mpmm_ff_cuda.x32_launches = 0  # launches of the f32-activation entry

_INT_X = {torch.int8: 8, torch.int16: 16}
_INT_W = {4: torch.int8, 8: torch.int8, 16: torch.int16}


def int_launch_plan(m: int, n: int, k: int, dataflow: str) -> dict:
    """How ``mpmm_int_cuda`` launches an [M, K] x [K, N] int product: K in
    ``stages`` ranges of ``stage_k`` rows (the grid's z; more than one are
    summed in range order, mod 2^32), 64 x 64 output tiles.  FF: 512-row
    stages.  CF: all of K in one range, or, from ``INT_SPLIT_MIN_K`` rows,
    every split into whole 64-row tiles (at least two a split, the most even
    of each count, and a split only up to two blocks per SM) is scored by
    ``wave_fill``, and the fewest splits within 90% of the best fill win.
    On the H100 this plan was the fastest or within 10% of it at every
    ResNet18 int shape of a sweep of the splits and of 128-row tiles
    (``tools/sweep_mpmm_plans.py``, numbers in PERF.md)."""
    tiles = -(-n // INT_TILE) * -(-m // INT_TILE)
    if dataflow == "ff":
        stage_k = FF_STAGE_K
    elif k < INT_SPLIT_MIN_K:
        stage_k = k
    else:
        fills = {}
        for splits, per in even_splits(k, TC_BK, TC_MIN_STEPS).items():
            if splits > 1 and tiles * splits > 2 * SMS:
                break  # a split only to fill the card, never past two blocks per SM
            fills[splits] = (wave_fill(tiles * splits), per)
        best = max(fill for fill, _ in fills.values())
        splits = min(s for s, (fill, _) in fills.items() if fill >= 0.9 * best)
        stage_k = fills[splits][1] * TC_BK if splits > 1 else k
    stages = -(-k // stage_k)
    return {"block_m": INT_TILE, "block_n": INT_TILE, "stage_k": stage_k, "stages": stages,
            "grid": (-(-n // INT_TILE), -(-m // INT_TILE), stages)}


def mpmm_int_cuda(
    x: torch.Tensor, w_data: torch.Tensor, *, w_bits: int, dataflow: str = "cf"
) -> torch.Tensor:
    """Launch the int-mode matmul on ``x``'s card: int8/int16 [M, K] times
    int4 (packed) / int8 / int16 weights -> [M, N] int32, exact mod 2^32, in
    the CF order or the FF order (512-row K stages spilled side by side,
    then summed in stage order); the CF order splits K the same way where
    its output tiles alone leave the card idle (:func:`int_launch_plan`)."""
    if w_bits not in _INT_W:
        raise ValueError(f"int mode takes w_bits 4, 8 or 16, got {w_bits}")
    if x.dtype not in _INT_X:
        raise TypeError(f"int mode takes int8 or int16 activations, got {x.dtype}")
    if dataflow not in ("cf", "ff"):
        raise ValueError(f"dataflow must be 'cf' or 'ff', got {dataflow!r}")
    m, k, n = _dims(x, w_data, w_bits, "mpmm_int_cuda")
    dev = x.device
    expect(x, "x", x.dtype, (m, k), dev)
    expect(w_data, "w_data", _INT_W[w_bits], (k // 2 if w_bits == 4 else k, n), dev)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    plan = int_launch_plan(m, n, k, dataflow)
    stage_k, stages = plan["stage_k"], plan["stages"]
    part = _stage_scratch(m, n, stages, torch.int32, out)
    err = _build.lib().mpmm_int_i32(
        x.data_ptr(), w_data.data_ptr(), out.data_ptr(), part.data_ptr(), m, n, k,
        _INT_X[x.dtype], w_bits, stage_k, stages, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "mpmm_int_i32")
    mpmm_int_cuda.launches += 1
    return out


mpmm_int_cuda.launches = 0
