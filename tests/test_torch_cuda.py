"""Each hand-written CUDA kernel of repro_torch against its plain PyTorch
version, on the card: the W4/W8 dequant matmul in the CF order (the
tensor-core kernel's 8-row tile at M <= 8, its 64- and 128-row tiles above,
at ragged edges and at the serving paths' prefill shapes) and the FF order,
the int-mode matmul (bit-exact against the CPU), paged decode and paged
prefill, contiguous-cache decode (``mqa_decode``), at small ragged shapes,
at llama3.2-3b's and zamba2-7b's widths and at ResNet18's conv shapes; and a
reduced zamba2-7b (hybrid) prefill + decode step on the card against the
CPU.

Marked ``cuda``: on a machine without a card every test skips with a
reason.  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: the outputs are bf16 and the kernel sums in f32 in another order
than the plain version, so one bf16 rounding step either way is expected:
``atol = rtol = 1e-2``.  The FF kernel's unscaled f32 output is held to its
plain version within float32 summation-order error: the products are exact
in f32, so ``atol`` is K * 2^-22 times the largest |x| * 127.  Int mode is
bit-exact.
"""
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.mpmm import mpmm_cuda, mpmm_ff_cuda, mpmm_int_cuda  # noqa: E402
from repro_torch.kernels.mqa_decode import mqa_decode_cuda  # noqa: E402
from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda  # noqa: E402
from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, exp):
    torch.testing.assert_close(got.float(), exp.float(), **TOL)


# ---------------------------------------------------------------- mpmm
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize(
    "m,k,n",
    [(1, 96, 40), (2, 3072, 1024), (3, 130, 64), (8, 3072, 1024), (37, 96, 200),
     (256, 3072, 3072), (5, 8192, 3072)],
)
def test_mpmm_kernel_matches_plain(dev, w_bits, m, k, n):
    rng = np.random.default_rng(m * 7 + n)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) / math.sqrt(k))
    w_data, w_scale = ops.pack_weights(w, w_bits)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    x, w_data, w_scale = x.to(dev), w_data.to(dev), w_scale.to(dev)
    before = mpmm_cuda.launches
    got = ops.mpmm(x, w_data, w_scale, w_bits=w_bits)
    torch.cuda.synchronize()
    assert mpmm_cuda.launches == before + 1
    _close(got, ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits))


# the tensor-core kernel (M > 8): ragged M, N % 16 != 0 (200), K with no
# 16-byte x rows (130) or a ragged last K step and a split (1100)
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m", [129, 300])
@pytest.mark.parametrize("n", [200, 1032])
@pytest.mark.parametrize("k", [96, 130, 1100])
def test_mpmm_tensor_core_edges(dev, w_bits, m, k, n):
    from repro_torch.kernels.mpmm import launch_plan

    rng = np.random.default_rng(m + 3 * k + n)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) / math.sqrt(k))
    w_data, w_scale = ops.pack_weights(w, w_bits)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    x, w_data, w_scale = x.to(dev), w_data.to(dev), w_scale.to(dev)
    assert launch_plan(m, n, k)["kernel"] == "tensor_core"
    got = mpmm_cuda(x, w_data, w_scale, w_bits=w_bits)
    _close(got, ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits))
    assert torch.equal(got, mpmm_cuda(x, w_data, w_scale, w_bits=w_bits))


@pytest.mark.parametrize(
    "m,k,n,w_bits",
    [(4096, 3584, 14576, 8),  # zamba2-7b in_proj at prefill M: 128-row tiles, no split
     (256, 3072, 1024, 4),  # llama3.2-3b k/v projection: split along K
     (128, 8192, 3072, 8)],  # llama3.2-3b down projection at the engine's chunk
)
def test_mpmm_path_shapes_repeat_bits(dev, m, k, n, w_bits):
    """At the shapes the serving paths launch: within tolerance of the plain
    version, and two runs give the same bits (the K split is summed in a
    fixed order)."""
    from repro_torch.kernels.mpmm import launch_plan

    gen = torch.Generator(device=dev).manual_seed(m + n)
    w_data, w_scale = ops.pack_weights(
        torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k), w_bits)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    got = mpmm_cuda(x, w_data, w_scale, w_bits=w_bits)
    _close(got, ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits))
    assert torch.equal(got, mpmm_cuda(x, w_data, w_scale, w_bits=w_bits))
    assert (launch_plan(m, n, k)["splits"] > 1) == (m < 4096)


# decode M: every batch bucket's row count and odd ones, K off the 64-row K
# step (1100: int4 with K % 128 != 0; 130), N off the 128-column tile
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("k,n", [(1100, 200), (130, 1032), (3072, 1024)])
def test_mpmm_decode_m_matches_plain_and_repeats_bits(dev, w_bits, m, k, n):
    from repro_torch.kernels.mpmm import DECODE_M, launch_plan

    gen = torch.Generator(device=dev).manual_seed(m * 13 + k + n)
    w_data, w_scale = ops.pack_weights(
        torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k), w_bits)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    assert launch_plan(m, n, k, w_bits=w_bits)["block_m"] == DECODE_M
    before = mpmm_cuda.launches
    got = mpmm_cuda(x, w_data, w_scale, w_bits=w_bits)
    torch.cuda.synchronize()
    assert mpmm_cuda.launches == before + 1
    _close(got, ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits))
    assert torch.equal(got, mpmm_cuda(x, w_data, w_scale, w_bits=w_bits))


def test_dense_w16_raises_on_the_card(dev):
    """A 16-bit quantized weight runs in int mode, whose card kernel takes
    int8 / int16 activations: a bf16 activation raises, naming its dtype."""
    from repro_torch.models.layers import dense

    w = {"data": torch.zeros(64, 32, dtype=torch.int16, device=dev),
         "scale": torch.ones(1, 32, device=dev), "bits": 16}
    with pytest.raises(ValueError, match="bfloat16"):
        dense(torch.zeros(2, 64, dtype=torch.bfloat16, device=dev), w)


def test_mpmm_entry_point_refuses_plans_that_do_not_fit(dev):
    """The C entry point takes the wrapper's plan and refuses one that does
    not cover K in whole K steps, or block rows it was not compiled for."""
    from repro_torch.kernels import _build

    m, k, n = 64, 1000, 128
    x = torch.zeros(m, k, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(k, n, dtype=torch.int8, device=dev)
    sc = torch.ones(n, device=dev)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    part = torch.empty(16, m, n, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(splits, per, block_m, rows=m):
        return _build.lib().mpmm_dequant_bf16(
            x.data_ptr(), w.data_ptr(), sc.data_ptr(), out.data_ptr(), part.data_ptr(),
            rows, n, k, 8, splits, per, block_m, stream)

    assert launch(8, 128, 64) == 0
    torch.cuda.synchronize()
    for bad in ((7, 128, 64), (9, 128, 64), (8, 120, 64), (8, 128, 96), (4, 256, 32)):
        assert launch(*bad) != 0, bad
    # the 8-row tile (M <= 8 only) steps through K 128 rows at a time
    assert launch(3, 384, 8, rows=8) == 0 and launch(4, 320, 8, rows=8) != 0
    assert launch(3, 384, 8, rows=9) != 0 and launch(2, 512, 0, rows=8) != 0
    torch.cuda.synchronize()


def test_mpmm_rejects_unported_modes(dev):
    """What no kernel takes raises on the card: f32 activations in dequant
    mode (both orders), float activations in int mode; nothing falls back."""
    x = torch.zeros(2, 8, dtype=torch.bfloat16, device=dev)
    wd = torch.zeros(8, 8, dtype=torch.int8, device=dev)
    ws = torch.ones(1, 8, device=dev)
    for df in ("cf", "ff", "auto"):
        with pytest.raises(ValueError, match="float32"):
            ops.mpmm(x.float(), wd, ws, w_bits=8, dataflow=df)
    with pytest.raises(TypeError, match="int8 or int16"):
        ops.mpmm(x, wd, ws, w_bits=8, mode="int")
    with pytest.raises(TypeError):
        mpmm_cuda(x.float(), wd, ws, w_bits=8)
    with pytest.raises(TypeError):
        mpmm_ff_cuda(x.float(), wd, w_bits=8)


# ------------------------------------------------------- mpmm, FF order
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize(
    "m,k,n",
    [(1, 96, 40), (8, 3072, 1024), (37, 130, 200), (300, 520, 130), (513, 1100, 64),
     (1568, 2304, 256), (392, 4608, 512)],
)
def test_mpmm_ff_kernel_matches_plain(dev, w_bits, m, k, n):
    rng = np.random.default_rng(m * 5 + k)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) / math.sqrt(k))
    w_data, w_scale = ops.pack_weights(w, w_bits)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    x, w_data, w_scale = x.to(dev), w_data.to(dev), w_scale.to(dev)
    acc = mpmm_ff_cuda(x, w_data, w_bits=w_bits)
    exp = ref.mpmm_ff_ref(x, w_data, w_bits=w_bits)
    atol = k * 2.0**-22 * x.float().abs().max().item() * 127
    torch.testing.assert_close(acc, exp, atol=atol, rtol=1e-5)
    assert torch.equal(acc, mpmm_ff_cuda(x, w_data, w_bits=w_bits))  # no atomics
    before = mpmm_ff_cuda.launches
    got = ops.mpmm(x, w_data, w_scale, w_bits=w_bits, dataflow="ff")
    torch.cuda.synchronize()
    assert mpmm_ff_cuda.launches == before + 1 and got.dtype == torch.bfloat16
    _close(got, ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits))
    if n % 8 == 0:  # the CF kernel reads 8 columns per load
        _close(got, ops.mpmm(x, w_data, w_scale, w_bits=w_bits, dataflow="cf"))


@pytest.mark.parametrize("k", [147, 27])
def test_mpmm_ff_kernel_takes_odd_k(dev, k):
    """The first conv of ResNet18 (K = 3*7*7) and of VGG16 (3*3*3): odd K,
    rows of x that start off any vector boundary."""
    rng = np.random.default_rng(k)
    m, n = 2000, 64
    w_data, w_scale = ops.pack_weights(torch.from_numpy(rng.normal(size=(k, n)).astype(
        np.float32)), 8)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    x, w_data, w_scale = x.to(dev), w_data.to(dev), w_scale.to(dev)
    acc = mpmm_ff_cuda(x, w_data, w_bits=8)
    torch.testing.assert_close(acc, ref.mpmm_ff_ref(x, w_data, w_bits=8),
                               atol=k * 2.0**-22 * 8 * 127, rtol=1e-5)


@pytest.mark.parametrize("entry", ["mpmm_ff_dequant_f32", "mpmm_int_i32"])
def test_ff_entry_points_refuse_stages_that_do_not_split_k(dev, entry):
    """The wrappers size the [stages, M, N] scratch from (stage_k, stages)
    and pass both; the C entry points refuse a pair that does not split K
    (and the FF kernel a stage size it was not compiled for), so a kernel
    cannot write past the scratch."""
    from repro_torch.kernels import _build

    m, k, n, stage_k = 16, 1100, 64, ref.FF_STAGE_K
    stages = -(-k // stage_k)
    ff = entry == "mpmm_ff_dequant_f32"
    x = torch.zeros(m, k, dtype=torch.bfloat16 if ff else torch.int8, device=dev)
    w = torch.zeros(k, n, dtype=torch.int8, device=dev)
    acc = torch.float32 if ff else torch.int32
    out = torch.empty(m, n, dtype=acc, device=dev)
    part = torch.empty(stages + 1, m, n, dtype=acc, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    call = getattr(_build.lib(), entry)

    def launch(stages):
        ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(), m, n, k)
        bits = (8,) if ff else (8, 8)  # w_bits; x_bits, w_bits
        return call(*ptrs, *bits, stage_k, stages, stream)

    assert launch(stages) == 0
    torch.cuda.synchronize()
    assert launch(stages - 1) != 0 and launch(stages + 1) != 0


# the FF order's stage counts 1, 2 and 9 (ragged last stages) at N = 64 (one
# warpgroup's columns masked) and N = 512, an odd N (weights staged by plain
# byte loads, column pairs straddling N), int4 with a ragged last stage
@pytest.mark.parametrize(
    "m,k,n,w_bits",
    [(m, k, n, w) for k in (320, 1000, 4500) for n in (64, 512) for m, w in ((200, 8), (70, 4))]
    + [(150, 1100, 77, 8), (150, 1100, 77, 4), (9, 520, 33, 8), (129, 1036, 96, 4)],
)
def test_mpmm_ff_kernel_stages_and_edges(dev, m, k, n, w_bits):
    from repro_torch.kernels.mpmm import launch_plan

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    w_data, w_scale = ops.pack_weights(
        torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k), w_bits)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    before = mpmm_ff_cuda.launches
    acc = mpmm_ff_cuda(x, w_data, w_bits=w_bits)
    assert mpmm_ff_cuda.launches == before + 1
    atol = k * 2.0**-22 * x.float().abs().max().item() * 127
    torch.testing.assert_close(acc, ref.mpmm_ff_ref(x, w_data, w_bits=w_bits), atol=atol,
                               rtol=1e-5)
    assert torch.equal(acc, mpmm_ff_cuda(x, w_data, w_bits=w_bits))
    _close(ops.mpmm(x, w_data, w_scale, w_bits=w_bits, dataflow="ff"),
           ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits))
    assert launch_plan(m, n, k, stage_k=ref.FF_STAGE_K)["splits"] == -(-k // 512)


def test_mpmm_ff_entry_point_plan_matches_wrapper(dev):
    """The FF entry point splits K at 512-row stages and picks its block rows
    by the rule of launch_plan(..., stage_k=512), at ResNet18's FF layers
    (batch 8) and small shapes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mpmm import launch_plan

    lib = _build.lib()
    for m, k, n in [(100352, 147, 64), (25088, 576, 64), (6272, 576, 128), (6272, 1152, 128),
                    (1568, 1152, 256), (1568, 2304, 256), (392, 2304, 512), (392, 4608, 512),
                    (8, 3072, 8192), (64, 100, 10), (65, 100, 10), (300, 520, 130)]:
        plan = launch_plan(m, n, k, stage_k=ref.FF_STAGE_K)
        assert plan["k_per_split"] == 512 and plan["splits"] == -(-k // 512)
        assert lib.mpmm_ff_block_m(m, n, k) == plan["block_m"], (m, k, n)


# ------------------------------------------------------- mpmm, int mode
def _int_operands(rng, m, k, n, w_bits, x_bits):
    xlim = 2 ** (x_bits - 1)
    x = rng.integers(-xlim, xlim, (m, k)).astype(np.int16 if x_bits == 16 else np.int8)
    wlim = 8 if w_bits == 4 else 2 ** (w_bits - 1)
    wq = rng.integers(-wlim, wlim, (k, n)).astype(np.int16 if w_bits == 16 else np.int8)
    wd = torch.from_numpy(wq)
    if w_bits == 4:
        from repro_torch.quant.pack import pack_int4

        wd = pack_int4(wd, dim=0)
    return torch.from_numpy(x), wd


@pytest.mark.parametrize("dataflow", ["cf", "ff"])
@pytest.mark.parametrize("w_bits,x_bits", [(16, 16), (8, 8), (4, 8), (8, 16), (16, 8)])
@pytest.mark.parametrize("m,k,n", [(32, 256, 128), (37, 146, 72), (200, 1100, 130)])
def test_mpmm_int_kernel_bit_exact(dev, w_bits, x_bits, dataflow, m, k, n):
    rng = np.random.default_rng(m + k + w_bits + x_bits)
    x, wd = _int_operands(rng, m, k, n, w_bits, x_bits)
    exp = ref.mpmm_ref(x, wd, None, w_bits=w_bits, mode="int")  # the CPU's int32 matmul
    before = mpmm_int_cuda.launches
    got = mpmm_int_cuda(x.to(dev), wd.to(dev), w_bits=w_bits, dataflow=dataflow)
    torch.cuda.synchronize()
    assert mpmm_int_cuda.launches == before + 1 and got.dtype == torch.int32
    assert torch.equal(got.cpu(), exp)


# a CF split with a short last split (2240 = 8 x 256 + 192; x rows 16-byte
# copies at int8 and int16), odd K (x by plain loads), odd N (w likewise)
# (int4 packs K in pairs, so odd K runs at 8 and 16 weight bits)
@pytest.mark.parametrize(
    "m,k,n,w_bits,x_bits",
    [(m, k, n, w, x) for m, k, n in [(392, 2240, 256), (300, 147, 64), (150, 1100, 77)]
     for w, x in [(8, 8), (4, 8), (16, 16), (8, 16), (4, 16)] if w != 4 or k % 2 == 0],
)
def test_mpmm_int_kernel_splits_and_edges(dev, m, k, n, w_bits, x_bits):
    from repro_torch.kernels.mpmm import int_launch_plan

    rng = np.random.default_rng(m + k + n + w_bits + x_bits)
    x, wd = _int_operands(rng, m, k, n, w_bits, x_bits)
    exp = ref.mpmm_ref(x, wd, None, w_bits=w_bits, mode="int")
    for dataflow in ("cf", "ff"):
        got = mpmm_int_cuda(x.to(dev), wd.to(dev), w_bits=w_bits, dataflow=dataflow)
        assert torch.equal(got.cpu(), exp), dataflow
    if (m, k) == (392, 2240):
        plan = int_launch_plan(m, n, k, "cf")
        assert plan["stages"] > 1 and k - (plan["stages"] - 1) * plan["stage_k"] < plan["stage_k"]


def test_mpmm_int_entry_point_takes_the_host_plan(dev):
    """The int entry point launches the K split int_launch_plan makes (whole
    64-row tiles, a short last one) at ResNet18's int shapes (batch 1 and 2)
    and small ones, and refuses a split off the K tiles."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mpmm import int_launch_plan

    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m, k, n in [(12544, 147, 64), (3136, 576, 64), (784, 576, 128), (1568, 1152, 128),
                    (392, 2304, 256), (196, 2304, 256), (98, 4608, 512), (49, 4608, 512),
                    (392, 2240, 256), (64, 1100, 64), (37, 146, 72)]:
        x = torch.zeros(m, k, dtype=torch.int8, device=dev)
        w = torch.zeros(k, n, dtype=torch.int8, device=dev)
        out = torch.empty(m, n, dtype=torch.int32, device=dev)
        part = torch.empty(-(-k // 64), m, n, dtype=torch.int32, device=dev)

        def launch(stage_k, stages):
            return lib.mpmm_int_i32(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    part.data_ptr(), m, n, k, 8, 8, stage_k, stages, stream)

        for dataflow in ("cf", "ff"):
            plan = int_launch_plan(m, n, k, dataflow)
            assert launch(plan["stage_k"], plan["stages"]) == 0, (m, k, n, dataflow)
        torch.cuda.synchronize()
        if (m, k) == (64, 1100):  # 128-row ranges are whole tiles; 120-row ones are not
            assert launch(128, 9) == 0 and launch(k, 1) == 0
            torch.cuda.synchronize()
            assert launch(120, 10) != 0 and launch(128, 8) != 0


@pytest.mark.parametrize("dataflow", ["cf", "ff"])
def test_mpmm_int_kernel_wraps_mod_2_32(dev, dataflow):
    x = torch.full((8, 1100), 32767, dtype=torch.int16)
    w = torch.full((1100, 64), 32767, dtype=torch.int16)
    w[:, 1] = -32768
    exp = ref.mpmm_ref(x, w, None, w_bits=16, mode="int")
    assert int(exp[0, 0]) == (1100 * 32767 * 32767 + 2**31) % 2**32 - 2**31
    got = mpmm_int_cuda(x.to(dev), w.to(dev), w_bits=16, dataflow=dataflow)
    assert torch.equal(got.cpu(), exp)


@pytest.mark.parametrize("mode", ["int", "dequant"])
@pytest.mark.parametrize("dataflow", ["ff", "cf"])
def test_mpconv_on_card_matches_cpu(dev, mode, dataflow):
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(3, 3, 24, 40)).astype(np.float32))
    wd, ws = ops.conv_pack_weights(w, 8)
    if mode == "int":
        x = torch.from_numpy(rng.integers(-32768, 32768, (2, 15, 15, 24)).astype(np.int16))
    else:
        x = torch.from_numpy(rng.normal(size=(2, 15, 15, 24)).astype(np.float32))
        x = x.to(torch.bfloat16)
    kw = dict(w_bits=8, ksize=3, stride=2, padding=1, mode=mode, dataflow=dataflow)
    got = ops.mpconv(x.to(dev), wd.to(dev), ws.to(dev), **kw).cpu()
    exp = ops.mpconv(x, wd, ws, **kw)
    if mode == "int":
        assert torch.equal(got, exp)
    else:
        _close(got, exp)


def test_run_network_on_card_matches_cpu(dev):
    from repro_torch.core.dataflow import ConvLayer
    from repro_torch.models import cnn

    layers = [ConvLayer("a", 3, 16, 7, 32, 32, 2, 3), ConvLayer("b", 16, 32, 3, 16, 16, 1, 1),
              ConvLayer("c", 32, 48, 1, 16, 16, 2, 0), ConvLayer("d", 48, 64, 3, 6, 6, 1, 1)]
    gen = torch.Generator().manual_seed(0)
    params = [ops.conv_pack_weights(torch.randn(l.k, l.k, l.cin, l.cout, generator=gen)
                                    / (l.k * l.cin ** 0.5), 8) for l in layers]
    x = torch.randn(2, 24, 24, 3, generator=gen)
    cpu32, dec = cnn.run_network("t", x, params, layers, device="cpu")
    cpu16, _ = cnn.run_network("t", x.to(torch.bfloat16), params, layers, device="cpu")
    card, dec_card = cnn.run_network(
        "t", x.to(torch.bfloat16).to(dev), [(a.to(dev), b.to(dev)) for a, b in params],
        layers, device=dev)
    assert dec_card == dec
    noise = (cpu16.float() - cpu32).abs()
    diff = (card.cpu().float() - cpu16.float()).abs()
    assert diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean()


# ------------------------------------------------------------ paged attention
def _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d):
    shape = (n_layers, n_pages, ps, hkv, d)
    if kv_bits == 16:
        kp = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
        vp = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
        return kp.to(dev), vp.to(dev), None, None
    kf = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    kq, ks = ops.quantize_kv(kf.reshape(-1, *shape[2:]), kv_bits)
    vq, vs = ops.quantize_kv(vf.reshape(-1, *shape[2:]), kv_bits)
    r = lambda t: t.reshape(n_layers, n_pages, *t.shape[1:]).to(dev)  # noqa: E731
    return r(kq), r(vq), r(ks), r(vs)


def _tokens(rng, dev, kv_bits, lead, d):
    x = torch.from_numpy(rng.normal(size=(*lead, d)).astype(np.float32))
    if kv_bits == 16:
        return x.to(torch.bfloat16).to(dev), None
    q, s = ops.quantize_kv(x.reshape(-1, 1, *x.shape[-2:]), kv_bits)
    return q.reshape(*lead[:-1], *q.shape[-2:]).to(dev), s.reshape(*lead, 1).to(dev)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 21, 200])
@pytest.mark.parametrize(
    "hkv,g,d,ps,w",
    [(2, 3, 64, 8, 9), (8, 3, 128, 16, 40), (4, 8, 128, 16, 12), (2, 2, 32, 16, 6)],
)
def test_paged_decode_kernel_matches_plain(dev, kv_bits, window, hkv, g, d, ps, w):
    """Ragged rows over one split and over several, with windows inside one
    split and across split boundaries; llama3.2-3b's heads (8 x 3 x 128),
    yi-9b's (4 x 8 x 128) and the reduced configs' (2 x 2 x 32)."""
    rng = np.random.default_rng(kv_bits + d)
    b, n_layers = 5, 2
    n_pages = b * w + 3
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ).to(dev)
    # empty, one token, mid-page, half and full table (stale pages past each length)
    lengths = torch.tensor([0, 1, 2 * ps + 3, w * ps // 2 + 5, w * ps], dtype=torch.int32,
                           device=dev)
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    nk, nks = _tokens(rng, dev, kv_bits, (b, hkv), d)
    nv, nvs = _tokens(rng, dev, kv_bits, (b, hkv), d)
    for layer in range(n_layers):
        before = paged_mqa_decode_cuda.launches
        got = ops.paged_mqa_decode(
            q, kp, vp, ks, vs, tables, lengths, layer, nk, nv, nks, nvs,
            kv_bits=kv_bits, window=window,
        )
        torch.cuda.synchronize()
        assert paged_mqa_decode_cuda.launches == before + 1
        exp = ref.paged_mqa_decode_ref(
            q, kp, vp, ks, vs, tables, lengths, layer, nk, nv, nks, nvs,
            sm_scale=1 / math.sqrt(d), kv_bits=kv_bits, window=window,
        )
        _close(got, exp)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 19])
@pytest.mark.parametrize("c", [1, 5, 32])
@pytest.mark.parametrize("hkv,g,d", [(2, 3, 64), (4, 8, 128), (2, 2, 32)])
def test_paged_prefill_kernel_matches_plain(dev, kv_bits, window, c, hkv, g, d):
    rng = np.random.default_rng(kv_bits * 100 + c)
    b, n_layers, ps, w = 3, 2, 8, 10
    n_pages = b * w
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ).to(dev)
    ctx = torch.tensor([0, 13, 40], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([c, max(c - 2, 0), (c + 1) // 2], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    for layer in range(n_layers):
        before = paged_mqa_prefill_cuda.launches
        got = ops.paged_mqa_prefill(
            q, kp, vp, ks, vs, tables, ctx, q_lens, layer, ck, cv, cks, cvs,
            kv_bits=kv_bits, window=window,
        )
        torch.cuda.synchronize()
        assert paged_mqa_prefill_cuda.launches == before + 1
        assert torch.isfinite(got.float()).all()  # padding rows too
        exp = ref.paged_mqa_prefill_ref(
            q, kp, vp, ks, vs, tables, ctx, q_lens, layer, ck, cv, cks, cvs,
            sm_scale=1 / math.sqrt(d), kv_bits=kv_bits, window=window,
        )
        _close(got, exp)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 100])
def test_paged_prefill_kernel_at_llama_width(dev, kv_bits, window):
    """llama3.2-3b's heads (Hkv 8, G 3, D 128) at the engine's chunk C = 128,
    contexts up to 384, ragged q_lens (a padding-only row too); two runs give
    the same bits."""
    rng = np.random.default_rng(kv_bits + (window or 0))
    b, n_layers, ps, hkv, g, d, c = 4, 2, 16, 8, 3, 128, 128
    w = -(-(384 + c) // ps)
    n_pages = b * w + 2
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor([256, 200, 384, 0], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([c, 77, 1, 0], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
    got = ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits,
                                    window=window)
    # row 3 has no context and no valid chunk key: its padding rows see
    # nothing, 0 from the kernel (as the Pallas kernel gives), 0 from the plain
    # version after its NaN guard
    _close(got, exp)
    assert torch.equal(got, ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window))


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("d", [40, 112])
def test_paged_prefill_kernel_pads_head_dim(dev, kv_bits, d):
    """Head dims that are no multiple of 16 are zero-padded in shared
    memory; rows of 20, 40, 56, 80, 112 and 224 bytes take 4-, 8- and
    16-byte copies."""
    rng = np.random.default_rng(d + kv_bits)
    b, n_layers, ps, hkv, g, c, w = 2, 1, 8, 2, 2, 20, 8
    n_pages = b * w
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(rng.permutation(n_pages).reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor([30, 41], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([c, 9], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 0, ck, cv, cks, cvs)
    got = ops.paged_mqa_prefill(*args, kv_bits=kv_bits)
    _close(got, ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits))


def test_paged_prefill_kernel_layout_matches_wrapper(dev):
    """The wrapper's grid plan uses the kernel's rows per block; head dims
    past the largest compiled one are refused before a launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_prefill import ROWS_PER_BLOCK

    assert _build.lib().paged_prefill_rows_per_block() == ROWS_PER_BLOCK
    q = torch.zeros(1, 1, 2, 1, 136, dtype=torch.bfloat16, device=dev)
    pool = torch.zeros(1, 2, 4, 1, 136, dtype=torch.bfloat16, device=dev)
    chunk = torch.zeros(1, 1, 2, 136, dtype=torch.bfloat16, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dims up to 128"):
        paged_mqa_prefill_cuda(q, pool, pool, None, None, one.reshape(1, 1), one, one, 0,
                               chunk, chunk, None, None, kv_bits=16, sm_scale=1.0)


# ------------------------------------------------- contiguous-cache decode
MQA_CASES = [
    # (B, S, Hkv, G, D, lengths): zamba2-7b serving (S = 512 + 32 + 8), the
    # reduced configs' D = 32 with short rows, llama3.2-3b's GQA with ragged
    # rows, a long row, and an empty row (0 out, as the Pallas kernel gives)
    (8, 552, 32, 1, 112, [545, 546, 547, 548, 549, 550, 551, 552]),
    (2, 300, 2, 2, 32, [5, 1]),
    (3, 1000, 8, 3, 128, [1000, 517, 33]),
    (1, 8192, 32, 1, 112, [8191]),
    (2, 70, 4, 1, 32, [0, 70]),
]


def _contiguous_kv(rng, dev, kv_bits, b, s, hkv, d):
    kv = []
    for _ in range(2):
        x = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
        kv.extend(ops.quantize_kv(x, kv_bits))
    kd, ks, vd, vs = (t.to(dev) for t in kv)
    return kd, vd, ks, vs


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("b,s,hkv,g,d,lengths", MQA_CASES)
def test_mqa_decode_kernel_matches_plain(dev, kv_bits, b, s, hkv, g, d, lengths):
    rng = np.random.default_rng(s + kv_bits)
    kd, vd, ks, vs = _contiguous_kv(rng, dev, kv_bits, b, s, hkv, d)
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = lens > 0
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        qd = q.to(dtype)
        before = mqa_decode_cuda.launches
        got = ops.mqa_decode(qd, kd, vd, ks, vs, lens, kv_bits=kv_bits)
        torch.cuda.synchronize()
        assert mqa_decode_cuda.launches == before + 1
        assert got.dtype == dtype and got.shape == (b, hkv * g, d)
        exp = ops.mqa_decode(qd.cpu(), kd.cpu(), vd.cpu(), ks.cpu(), vs.cpu(), lens.cpu(),
                             kv_bits=kv_bits)
        torch.testing.assert_close(got[live].float().cpu(), exp[live.cpu()].float(), **tol)
        assert (got[~live] == 0).all()
        # the same inputs give the same bits (fixed-order merge)
        assert torch.equal(got, ops.mqa_decode(qd, kd, vd, ks, vs, lens, kv_bits=kv_bits))
    # payloads past each row's length are never read
    dirty = kd.clone()
    for i, n in enumerate(lengths):
        dirty[i, n:] = -128
    again = ops.mqa_decode(q.to(torch.bfloat16), dirty, vd, ks, vs, lens, kv_bits=kv_bits)
    assert torch.equal(again, ops.mqa_decode(q.to(torch.bfloat16), kd, vd, ks, vs, lens,
                                             kv_bits=kv_bits))


# lengths around the 8-token tiles and the 32-position rounds of the block's
# warps: 0, 1, 31, 32, 33 and S, with S a multiple of neither (77) or split
# across blocks (300); D = 112 (kv4: 56-byte rows, 8-byte copies), G = 3
# at D = 128, G = 5 (two query groups per kv head)
@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("s", [77, 300])
@pytest.mark.parametrize("g,d", [(1, 112), (3, 128), (5, 64)])
def test_mqa_decode_kernel_tile_boundaries(dev, kv_bits, s, g, d):
    from repro_torch.kernels.mqa_decode import decode_plan

    lengths = [0, 1, 31, 32, 33, s]
    b, hkv = len(lengths), 2
    rng = np.random.default_rng(s + g + kv_bits)
    kd, vd, ks, vs = _contiguous_kv(rng, dev, kv_bits, b, s, hkv, d)
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    assert (decode_plan(b, hkv, g, s)["splits"] > 1) == (s == 300)
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        qd = q.to(dtype)
        got = ops.mqa_decode(qd, kd, vd, ks, vs, lens, kv_bits=kv_bits)
        exp = ops.mqa_decode(qd.cpu(), kd.cpu(), vd.cpu(), ks.cpu(), vs.cpu(), lens.cpu(),
                             kv_bits=kv_bits)
        assert got.dtype == dtype
        torch.testing.assert_close(got[1:].float().cpu(), exp[1:].float(), **tol)
        assert (got[0] == 0).all()
        assert torch.equal(got, ops.mqa_decode(qd, kd, vd, ks, vs, lens, kv_bits=kv_bits))


def test_mqa_decode_kernel_rejects_what_it_does_not_take(dev):
    kd = torch.zeros(1, 8, 2, 30, dtype=torch.int8, device=dev)  # 30-byte rows
    sc = torch.ones(1, 8, 2, 1, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    q = torch.zeros(1, 2, 1, 30, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="32-bit words"):
        mqa_decode_cuda(q, kd, kd, sc, sc, lens, kv_bits=8, sm_scale=1.0)
    q = torch.zeros(1, 2, 1, 32, dtype=torch.float16, device=dev)
    kd = torch.zeros(1, 8, 2, 32, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        mqa_decode_cuda(q, kd, kd, sc, sc, lens, kv_bits=8, sm_scale=1.0)
    with pytest.raises(ValueError, match="kv_bits"):
        mqa_decode_cuda(q.to(torch.bfloat16), kd, kd, sc, sc, lens, kv_bits=16, sm_scale=1.0)


def test_mqa_decode_kernel_rejects_wide_heads(dev):
    """Head dims past 128 raise in the wrapper (q quarters live in registers)."""
    q = torch.zeros(1, 2, 1, 160, dtype=torch.bfloat16, device=dev)
    kd = torch.zeros(1, 8, 2, 160, dtype=torch.int8, device=dev)
    sc = torch.ones(1, 8, 2, 1, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dims up to 128"):
        mqa_decode_cuda(q, kd, kd, sc, sc, lens, kv_bits=8, sm_scale=1.0)


def test_hybrid_prefill_and_decode_on_card_match_cpu(dev):
    """Reduced zamba2-7b (w8/kv8, bf16) with a tail: prefill and two decode
    steps on the card against the CPU, within twice the CPU's own
    bf16-vs-float32 logit error; the card's decode steps launch the
    mqa_decode kernel once per shared-attention application."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), n_layers=5)
    params = T.quantize_params(T.init_params(cfg, torch.Generator().manual_seed(0)), 8)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)))
    steps = [torch.tensor([[3], [7]]), torch.tensor([[11], [2]])]

    def run(device, dtype="bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = _to(params, device)
        logits, cache = T.prefill(p, {"tokens": tokens.to(device)}, c, 16)
        out = [logits.cpu()]
        for tok in steps:
            logits, cache = T.decode_step(p, tok.to(device), cache, c)
            out.append(logits.cpu())
        return out

    before = mqa_decode_cuda.launches
    card = run(dev)
    torch.cuda.synchronize()
    assert mqa_decode_cuda.launches == before + 2 * (cfg.n_layers // cfg.attn_every)
    cpu16, cpu32 = run("cpu"), run("cpu", "float32")
    for a, e, f in zip(card, cpu16, cpu32):
        a, e, f = a[:, : cfg.vocab], e[:, : cfg.vocab], f[:, : cfg.vocab]
        assert torch.isfinite(a).all()
        diff, noise = (a - e).abs(), (f - e).abs()
        assert diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
