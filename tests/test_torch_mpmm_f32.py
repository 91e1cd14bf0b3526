"""Float32 activations in the dequant matmul, on the CPU against the JAX
package: ``ops.mpmm`` on f32 ``x`` in both orders (the JAX side runs its
Pallas kernel in interpret mode, as ``tests/test_kernels_mpmm.py`` does),
the meta contract's shape and dtype for f32 ``x`` (the dry run's view of
the f32 entry), the port's quickstart section 4 (f32, ``dataflow="auto"``)
against the JAX quickstart's numbers, and ``launch.cnn`` (float32 on every
device, as ``examples/cnn_inference_speed.py`` runs) against JAX's
``run_network`` on the same input and weights.  On the card the same calls
launch the f32 entries (``tests/test_torch_cuda.py``, ``-k x32``).

Tolerances: the reference's float32 mpmm tolerance, 2e-3; the network's
float32 activations within 1e-4 of their largest value (three layers of
f32 sums in another order).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.cnn_zoo import BENCHMARK_NETWORKS as JNETS  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mpmm import (  # noqa: E402
    X32_BK, X32_BLOCK_M, launch_plan, mpmm_cuda, mpmm_ff_cuda, x32_launch_plan)
from repro_torch.kernels.ref import FF_STAGE_K  # noqa: E402
from repro_torch.launch import cnn as tcnn_cli  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

F32_TOL = dict(atol=2e-3, rtol=2e-3)
# (M, K, N): a decode-sized M, ragged edges against the kernel's 64 x 64
# tiles and 16-row K step, more than one 512-row FF stage, a K split
SHAPES = [(8, 256, 128), (37, 520, 200), (130, 1100, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _launches():
    return (mpmm_cuda.launches, mpmm_cuda.x32_launches, mpmm_ff_cuda.launches,
            mpmm_ff_cuda.x32_launches)


@pytest.mark.parametrize("dataflow", ["cf", "ff", "auto"])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_f32_mpmm_matches_jax(m, k, n, w_bits, dataflow):
    rng = np.random.default_rng(m * 7 + k + n + w_bits)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jd, js = jops.pack_weights(jnp.asarray(w), w_bits)
    exp = np.asarray(jops.mpmm(jnp.asarray(x), jd, js, w_bits=w_bits, dataflow=dataflow,
                               interpret=True))
    assert exp.dtype == np.float32
    before = _launches()
    got = ops.mpmm(_t(x), _t(jd), _t(js), w_bits=w_bits, dataflow=dataflow)
    assert _launches() == before  # the CPU runs the plain versions
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), exp, **F32_TOL)


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", SHAPES + [(1, 3072, 8192), (256, 3072, 3072)])
def test_f32_meta_contract_shape_and_dtype(m, k, n, w_bits):
    """The CF kernel's meta contract takes f32 activations and returns the
    f32 entry's output; its plan tiles M in 8 rows at M <= 8 (else 64) and
    splits K in whole K steps of its tile (128 rows at 8, else 32)."""
    meta = dict(device="meta")
    x = torch.empty(m, k, **meta)
    wd = torch.empty(k // 2 if w_bits == 4 else k, n, dtype=torch.int8, **meta)
    ws = torch.empty(1, n, **meta)
    out = ops.mpmm(x, wd, ws, w_bits=w_bits)
    assert out.is_meta and out.shape == (m, n) and out.dtype == torch.float32
    assert ops.mpmm(x, wd, ws, w_bits=w_bits, out_dtype=torch.float32).dtype == torch.float32
    plan = x32_launch_plan(m, n, k, w_bits=w_bits)
    assert plan["block_m"] == (8 if m <= 8 else X32_BLOCK_M) and plan["block_n"] == 128
    assert plan["k_per_split"] % (128 if plan["block_m"] == 8 else X32_BK) == 0
    assert (plan["splits"] - 1) * plan["k_per_split"] < k <= plan["splits"] * plan["k_per_split"]
    assert plan["grid"] == (-(-n // 128), -(-m // plan["block_m"]), plan["splits"])


@pytest.mark.parametrize("m,k,n", SHAPES + [(8, 3072, 8192), (256, 3072, 3072),
                                            (1568, 2304, 256), (1568, 128, 256),
                                            (100352, 147, 64)])
def test_x32_launch_plan_follows_the_bf16_kernels_split(m, k, n):
    """The f32 kernel takes the bf16 kernel's K split (the CF order's, its
    decode split at M <= 8; the FF order's 512-row stages, on 64-row tiles
    at any M), so both orders keep their fixed-order second passes."""
    for w_bits in (4, 8):
        cf, bf = x32_launch_plan(m, n, k, w_bits=w_bits), launch_plan(m, n, k, w_bits=w_bits)
        assert (cf["splits"], cf["k_per_split"]) == (bf["splits"], bf["k_per_split"])
    ff = x32_launch_plan(m, n, k, stage_k=FF_STAGE_K)
    assert ff["splits"] == -(-k // FF_STAGE_K) and ff["k_per_split"] == FF_STAGE_K
    assert ff["block_m"] == X32_BLOCK_M


# ---- the kernel's arithmetic: x as two TF32 terms ------------------------
# The card rounds with cvt.rna.tf32.f32: to 10 fraction bits, ties away from
# zero.  On the sign-magnitude bits that is: add half the dropped field
# (0x1000) to the magnitude, clear the 13 dropped bits; a carry out of the
# largest binade gives inf.  NaN stays NaN.
TF32_MAX = np.float32(np.uint32(0x7F7FE000).view(np.float32))  # TF32's largest finite


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    out = sign | torch.where(mag < 0x7F800000, (mag + 0x1000) & ~0x1FFF, mag)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split_tf32 (csrc/mpmm.cu): hi = rna(x), taken back to
    TF32's largest finite value where a finite x rounds past it; lo =
    rna(x - hi), or 0 for an infinite x."""
    hi = _tf32_rna(x)
    hi = torch.where(hi.isinf() & ~x.isinf(), torch.copysign(torch.tensor(TF32_MAX), x), hi)
    lo = torch.where(x.isinf(), torch.zeros_like(x), _tf32_rna(x - hi))
    return hi, lo


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


def _extreme_x(rng) -> torch.Tensor:
    """Normal draws over f32's whole exponent range, the TF32 rounding ties,
    and the ends: zeros, subnormals, +-2^-126, +-2^126, values that round
    past TF32's largest finite value, +-FLT_MAX."""
    f32 = np.finfo(np.float32)
    spread = rng.normal(size=4096) * np.exp2(rng.integers(-140, 127, size=4096))
    ties = (1 + np.arange(1, 64) * 2.0**-10 + 2.0**-11) * np.exp2(rng.integers(-100, 100, 63))
    ends = [0.0, -0.0, 1e-45, -1e-45, 2.0**-149, 1e-40, -3e-39, 2.0**-126, -(2.0**-126),
            2.0**126, -(2.0**126), 3.4012e38, -3.4014e38, 3.4025e38, float(f32.max),
            -float(f32.max), 2.0**-137, 3 * 2.0**-138]
    return torch.from_numpy(np.concatenate([spread, ties, -ties, ends]).astype(np.float32))


def test_tf32_split_reconstructs_x():
    """hi and lo are TF32 values (13 low bits clear) and hi + lo is x to
    within 2^-22 |x|; below TF32's normal range (|x| < 2^-115, where lo
    becomes subnormal) to within half TF32's smallest step, 2^-137.  Near
    FLT_MAX, rna(x) is inf and the kernel takes hi = TF32's largest finite
    value (lo carries the rest, still within 2^-22 |x|); an infinite x
    gives hi = x, lo = 0; NaN gives NaN."""
    x = _extreme_x(np.random.default_rng(0))
    hi, lo = _split_tf32(x)
    assert not bool(_low_bits(hi).any()) and not bool(_low_bits(lo).any())
    err = (hi.double() + lo.double() - x.double()).abs()
    bound = torch.maximum(x.double().abs() * 2.0**-22, torch.tensor(2.0**-137, dtype=torch.float64))
    assert bool((err <= bound).all()), float((err / bound).max())
    assert bool(hi.isfinite().all()) and bool(lo.isfinite().all())
    # past TF32's largest finite value: rna gives inf, the split does not
    big = torch.tensor([3.4025e38, -float(np.finfo(np.float32).max)])
    assert bool(_tf32_rna(big).isinf().all())
    assert _split_tf32(big)[0].abs().tolist() == [float(TF32_MAX)] * 2
    # a tie rounds away from zero; lo is then negative
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)])
    assert _split_tf32(tie)[0].tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, lo = _split_tf32(special)
    assert hi[:2].tolist() == [float("inf"), float("-inf")] and lo[:2].tolist() == [0.0, 0.0]
    assert bool(hi[2].isnan())


@pytest.mark.parametrize("w_bits,w_ends", [(8, (-128, 127)), (4, (-8, 7))], ids=["w8", "w4"])
@pytest.mark.parametrize("k", [128, 2304, 3072])  # rows 3x / 4x: layer3.0.down, 4x, 3a and 3b
def test_two_tf32_passes_stay_within_x32_tol(k, w_bits, w_ends):
    """sum(hi * w) + sum(lo * w), each product and sum in float64, against
    the float64 product x @ w, within the card check's x32_tol (atol K *
    2^-22 * max|x| * 127, rtol 1e-5): random x and x at the split's worst
    case (each lo rounding off by its most), times random weights and
    weights all at either end of their range."""
    rng = np.random.default_rng(k + w_bits)
    # hi = 1 + 2^-10, lo = -(2^-11 - 2^-23) rounds to -2^-11: off by 2^-23, a lo's most
    worst = np.float32(1 + 2.0**-11 + 2.0**-23)
    xs = np.stack([rng.normal(size=k), rng.normal(size=k) * 1e4, np.full(k, worst),
                   np.full(k, -worst) * 2.0**100, rng.normal(size=k) * 2.0**-120])
    ws = np.stack([rng.integers(w_ends[0], w_ends[1] + 1, size=k),
                   np.full(k, w_ends[0]), np.full(k, w_ends[1])], axis=1).astype(np.float64)
    for xr in xs.astype(np.float32):
        x = torch.from_numpy(xr)
        hi, lo = _split_tf32(x)
        got = hi.double() @ torch.from_numpy(ws) + lo.double() @ torch.from_numpy(ws)
        exp = x.double() @ torch.from_numpy(ws)
        atol = k * 2.0**-22 * float(x.abs().max()) * 127
        assert bool(((got - exp).abs() <= atol + 1e-5 * exp.abs()).all()), (got - exp).tolist()


def test_f32_contract_refuses_what_no_kernel_takes():
    """f16 activations raise on meta as on the card; an f32 activation
    asked for a bf16 output raises; nothing is cast."""
    meta = dict(device="meta")
    wd = torch.empty(64, 64, dtype=torch.int8, **meta)
    ws = torch.empty(1, 64, **meta)
    with pytest.raises(ValueError, match="bf16 activations or float32"):
        ops.mpmm(torch.empty(8, 64, dtype=torch.float16, **meta), wd, ws, w_bits=8)
    with pytest.raises(ValueError, match="dequant mode writes x.dtype"):
        ops.mpmm(torch.empty(8, 64, **meta), wd, ws, w_bits=8, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="writes f32"):
        torch.ops.repro_torch.mpmm(torch.empty(8, 64, **meta), wd, ws, 8, torch.bfloat16)


def test_quickstart_section_4_matches_the_jax_quickstart():
    out = quickstart.main(["--device", "cpu"])["mpmm"]
    # the JAX example's draws: section 2's ints, then x and w of section 4
    rng = np.random.default_rng(0)
    rng.integers(-7, 8, (8, 6, 6))
    rng.integers(-7, 8, (8, 8, 3, 3))
    xf = jnp.asarray(rng.normal(size=(64, 512)), jnp.float32)
    wf = jnp.asarray(rng.normal(size=(512, 256)), jnp.float32)
    wd, ws = jops.pack_weights(wf, 4)
    y = jops.mpmm(xf, wd, ws, w_bits=4, dataflow="auto", interpret=True)
    ref = xf @ wf
    rel = float(jnp.linalg.norm(y - ref) / jnp.linalg.norm(ref))
    assert out["dataflow"] == jops.select_matmul_dataflow(64, 256, 512).name
    assert out["payload_bytes"] == wd.size and out["launches"] == 0
    assert out["y"].dtype == torch.float32
    np.testing.assert_allclose(out["y"].numpy(), np.asarray(y), **F32_TOL)
    assert abs(out["rel_err"] - rel) < 1e-4


def test_cnn_cli_float32_matches_jax_run_network():
    """``launch.cnn``'s numerics: its seeded f32 input and weights through
    JAX's ``run_network`` (Pallas interpret) give its activation."""
    report = tcnn_cli.main(["--net", "ResNet18", "--layers", "3", "--device", "cpu"])
    assert report["dtype"] == "torch.float32"
    _, params = cnn.init_network("ResNet18", 0, w_bits=8, device="cpu")
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    jparams = [(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())) for a, b in params[:3]]
    exp, decisions = jcnn.run_network("ResNet18", jnp.asarray(x.numpy()), jparams,
                                      JNETS["ResNet18"]()[:3], w_bits=8, interpret=True)
    exp = np.asarray(exp)
    assert report["decisions"] == decisions and exp.dtype == np.float32
    got = report["activation"].numpy()
    assert got.shape == exp.shape == report["shape"]
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4 * np.abs(exp).max())
