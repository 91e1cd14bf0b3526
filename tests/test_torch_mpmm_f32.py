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
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.cnn_zoo import BENCHMARK_NETWORKS as JNETS  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mpmm import mpmm_cuda, mpmm_ff_cuda, x32_launch_plan  # noqa: E402
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
    f32 entry's output; its plan splits K in whole 16-row steps."""
    meta = dict(device="meta")
    x = torch.empty(m, k, **meta)
    wd = torch.empty(k // 2 if w_bits == 4 else k, n, dtype=torch.int8, **meta)
    ws = torch.empty(1, n, **meta)
    out = ops.mpmm(x, wd, ws, w_bits=w_bits)
    assert out.is_meta and out.shape == (m, n) and out.dtype == torch.float32
    assert ops.mpmm(x, wd, ws, w_bits=w_bits, out_dtype=torch.float32).dtype == torch.float32
    plan = x32_launch_plan(m, n, k)
    assert plan["k_per_split"] % 16 == 0
    assert (plan["splits"] - 1) * plan["k_per_split"] < k <= plan["splits"] * plan["k_per_split"]


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
