"""Each hand-written CUDA kernel of repro_torch against its plain PyTorch
version, on the card: the W4/W8 dequant matmul in the CF order (the
tensor-core kernel's 8-row tile at M <= 8, its 64- and 128-row tiles above,
at ragged edges and at the serving paths' prefill shapes; its f32 entry, a
row-split partial under the TP mapping, and the plain row-split partial
GEMM) and the FF order,
the f32-activation entries of both orders (at the serving paths' shapes,
at every ResNet18 conv, at ragged edges, through the three dispatch
routes, in the float32 CNN path, and the f16 / int activations they
refuse), the bf16 entries' bits on fixed inputs (digests taken before the
f32 entries were added), the int-mode matmul (bit-exact against the CPU),
paged decode and paged
prefill (also at a speculative verify window, at gemma3-1b's head dim 256
and at 160 / 192, which pad to 256, at one query head per kv head as
musicgen-medium has, and paged prefill at paligemma-3b's verify window;
their f32 instantiations, a float32 model's, at llama3.2-3b's, gemma3-1b's
and paligemma-3b's heads and D 64 / 192, held within f32 summation-order
error, ``atol = rtol = 1e-4``), the
MoE FFN (``models/moe.py``:
the CF kernel per expert) against the CPU's plain path, captured and eager,
contiguous-cache decode
(``mqa_decode``), at small ragged shapes, at llama3.2-3b's and zamba2-7b's
widths and at ResNet18's conv shapes; a reduced zamba2-7b (hybrid) prefill +
decode step on the card against the CPU; the sampler
(``ops.sample_tokens``, plain torch ops) on the card against the CPU; and
the captured serving steps (``serve/graphs.py``): the engine's decode step,
spec round and chunk call and the waves' decode step, captured and replayed
three times with new inputs, bit-equal to the eager step (outputs and
pools), a replay adding its capture's launch counts, and a step that reads
the card back inside a capture raising; the one-shot prefix prefill's
``PagedKVCache.write_prompt`` keeping every card pool's storage, and a decode
step captured before such a prefill reading its pages on replay; and the
training path (it holds none of the kernels): a train step of a reduced
llama3.2-3b on the card against the CPU, a Trainer run resumed from its
checkpoint bit-equal to an uninterrupted one on the card, and a finite
full-width mamba2-130m train step; and the multi-device modules over a
real NCCL process group of world size 1: ``compressed_grad_reduce`` on
the card against the CPU (gloo; int8 payloads and scales bit for bit), the
all-to-all MoE dispatch bit-equal to the replicated one, and a one-stage
``pipeline_apply``; and the dispatch's three routes (a CUDA tensor
launches, a CPU tensor runs the plain version, a meta tensor gets the
kernel's contract).

Marked ``cuda``: on a machine without a card every test skips with a
reason.  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: the f32-activation entries split x into two TF32 terms whose
sum is x to within 2^-22 |x|, and the integer weights are exact, so every
product is within 2^-22 |x| * 127 of its f32 value; they are held to their
plain versions within that and f32 summation-order error (``atol``
K * 2^-22 * max|x| * 127, times the largest scale where the output is
scaled; ``rtol`` 1e-5).  Otherwise the outputs are bf16 and the kernel
sums in f32 in another order than the plain version, so one bf16 rounding
step either way is expected: ``atol = rtol = 1e-2``.  The FF kernel's unscaled f32 output is held to its
plain version within float32 summation-order error: the products are exact
in f32, so ``atol`` is K * 2^-22 times the largest |x| * 127.  Int mode is
bit-exact.
"""
import dataclasses
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, prng, ref  # noqa: E402
from repro_torch.kernels.mpmm import mpmm_cuda, mpmm_ff_cuda, mpmm_int_cuda  # noqa: E402
from repro_torch.kernels.mqa_decode import mqa_decode_cuda  # noqa: E402
from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda  # noqa: E402
from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda  # noqa: E402
from repro_torch.quant.pack import pack_int4  # noqa: E402

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


@pytest.mark.parametrize("m", [8, 256])
def test_dispatch_card_cpu_meta(dev, m):
    """The three routes of ``ops.mpmm`` and ``ops.mqa_decode``: a CUDA
    tensor launches the kernel, a CPU tensor runs the plain version, a meta
    tensor gets the kernel's contract (the CUDA wrapper's checks and
    outputs, no launch), whose shape and dtype are the launch's."""
    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, 3072, generator=g).to(torch.bfloat16)
    wd, ws = ops.pack_weights(torch.randn(3072, 1024, generator=g) / 55.4, 4)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (x, wd, ws)]
    before = mpmm_cuda.launches
    got = ops.mpmm(x.to(dev), wd.to(dev), ws.to(dev), w_bits=4)
    assert mpmm_cuda.launches == before + 1
    plain = ops.mpmm(x, wd, ws, w_bits=4)
    contract = ops.mpmm(*meta, w_bits=4)
    assert mpmm_cuda.launches == before + 1
    assert contract.is_meta and contract.shape == got.shape == plain.shape
    assert contract.dtype == got.dtype == plain.dtype
    _close(got.cpu(), plain)
    q = torch.randn(2, 6, 128, generator=g).to(torch.bfloat16)
    kd, ks = ops.quantize_kv(torch.randn(2, 40, 2, 128, generator=g), 8)
    vd, vs = ops.quantize_kv(torch.randn(2, 40, 2, 128, generator=g), 8)
    lens = torch.tensor([40, 17], dtype=torch.int32)
    args = (q, kd, vd, ks, vs, lens)
    before = mqa_decode_cuda.launches
    got = ops.mqa_decode(*(t.to(dev) for t in args), kv_bits=8)
    assert mqa_decode_cuda.launches == before + 1
    contract = ops.mqa_decode(*(torch.empty(t.shape, dtype=t.dtype, device="meta")
                                for t in args), kv_bits=8)
    assert mqa_decode_cuda.launches == before + 1
    assert contract.is_meta and contract.shape == got.shape and contract.dtype == got.dtype
    _close(got.cpu(), ops.mqa_decode(*args, kv_bits=8))


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


# the f32 entry (a row-split partial product under the TP mapping): the
# scaled f32 sum uncast, at one rank's W8 / W4 row blocks of llama3.2-3b's
# wo and wd and at ragged shapes (8-row tile, K split, ragged N); within
# f32 summation-order error of the plain version, and cast to bf16 the
# bf16 entry's bits
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(3, 768, 3072), (8, 2048, 3072), (256, 768, 3072),
                                   (300, 1100, 200), (5, 1100, 200)])
def test_mpmm_f32_out_matches_plain_and_the_bf16_entry(dev, w_bits, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m * 3 + k + n)
    w_data, w_scale = ops.pack_weights(
        torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k), w_bits)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    before = mpmm_cuda.launches
    got = ops.mpmm(x, w_data, w_scale, w_bits=w_bits, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mpmm_cuda.launches == before + 1 and got.dtype == torch.float32
    exp = ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits, out_dtype=torch.float32)
    atol = k * 2.0**-22 * x.float().abs().max().item() * 127 * w_scale.max().item()
    torch.testing.assert_close(got, exp, atol=atol, rtol=1e-5)
    assert torch.equal(got.to(torch.bfloat16), mpmm_cuda(x, w_data, w_scale, w_bits=w_bits))
    assert torch.equal(got, mpmm_cuda(x, w_data, w_scale, w_bits=w_bits,
                                      out_dtype=torch.float32))


def test_row_split_partial_gemm_on_the_card(dev):
    """A plain row-split partial (``layers._MatmulF32``): one bf16 GEMM
    writing f32, within f32 summation-order error of the upcast product;
    its gradients those of the unsplit bf16 product."""
    from repro_torch.models.layers import _MatmulF32

    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, 5, 768, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(768, 3072, generator=gen, device=dev) / 768 ** 0.5).to(torch.bfloat16)
    r = torch.randn(2, 5, 3072, generator=gen, device=dev).to(torch.bfloat16)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = _MatmulF32.apply(xs, ws)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 3072)
    exp = x.float() @ w.float()
    atol = 768 * 2.0**-22 * x.float().abs().max().item() * w.float().abs().max().item()
    torch.testing.assert_close(got, exp, atol=atol, rtol=1e-5)
    (got.to(torch.bfloat16) * r).sum().backward()
    xu, wu = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (torch.matmul(xu, wu) * r).sum().backward()
    assert xs.grad.dtype == ws.grad.dtype == torch.bfloat16
    _close(xs.grad, xu.grad)
    _close(ws.grad, wu.grad)


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
    """What no kernel takes raises on the card: f16 or int activations in
    dequant mode (both orders), float activations in int mode, f32
    activations asked for a bf16 output; nothing falls back or casts."""
    x = torch.zeros(2, 8, dtype=torch.bfloat16, device=dev)
    wd = torch.zeros(8, 8, dtype=torch.int8, device=dev)
    ws = torch.ones(1, 8, device=dev)
    for bad in (torch.float16, torch.int8, torch.int16):
        for df in ("cf", "ff", "auto"):
            with pytest.raises(ValueError, match="bf16 activations or float32"):
                ops.mpmm(x.to(bad), wd, ws, w_bits=8, dataflow=df)
        with pytest.raises(TypeError):
            mpmm_cuda(x.to(bad), wd, ws, w_bits=8)
        with pytest.raises(TypeError):
            mpmm_ff_cuda(x.to(bad), wd, w_bits=8)
    with pytest.raises(TypeError, match="int8 or int16"):
        ops.mpmm(x, wd, ws, w_bits=8, mode="int")
    with pytest.raises(ValueError, match="writes f32"):
        mpmm_cuda(x.float(), wd, ws, w_bits=8, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dequant mode writes x.dtype"):
        ops.mpmm(x.float(), wd, ws, w_bits=8, out_dtype=torch.bfloat16)


# ------------------------------------------- mpmm, float32 activations
# The f32-activation entries (mpmm_dequant_x32, mpmm_ff_dequant_x32) against
# their plain versions at phase 2's serving shapes and at every ResNet18
# conv (batch 2), w4 (where K is even) and w8, CF and FF.  The kernel
# multiplies the exact integer weights by x's two TF32 terms (hi + lo = x
# to within 2^-22 |x|), so a product is within 2^-22 |x| * 127 of the f32
# product, and the sums run in another order: atol = K * 2^-22 * max|x| *
# 127 (times the largest scale where the output is scaled), rtol 1e-5.  Two
# runs give the same bits (fixed-order split sums, no atomics).
X32_SERVING = [(m, k, n) for k, n in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
                                      (3072, 128256)) for m in (1, 8, 40, 256)]


def _resnet18_shapes(batch=2):
    from repro_torch.models.cnn_zoo import BENCHMARK_NETWORKS

    out = []
    for l in BENCHMARK_NETWORKS["ResNet18"]():
        ho = (l.h + 2 * l.padding - l.k) // l.stride + 1
        wo = (l.w + 2 * l.padding - l.k) // l.stride + 1
        out.append((l.name, batch * ho * wo, l.cin * l.k * l.k, l.cout))
    return out


def _x32_check(dev, m, k, n, w_bits, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) / math.sqrt(k))
    w_data, w_scale = (t.to(dev) for t in ops.pack_weights(w.to(dev), w_bits))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    xmax = x.abs().max().item()
    before = (mpmm_cuda.launches, mpmm_cuda.x32_launches, mpmm_ff_cuda.launches,
              mpmm_ff_cuda.x32_launches)
    cf = ops.mpmm(x, w_data, w_scale, w_bits=w_bits, dataflow="cf")
    acc = mpmm_ff_cuda(x, w_data, w_bits=w_bits)
    ff = ops.mpmm(x, w_data, w_scale, w_bits=w_bits, dataflow="ff")
    torch.cuda.synchronize()
    assert cf.dtype == ff.dtype == acc.dtype == torch.float32
    assert (mpmm_cuda.launches, mpmm_cuda.x32_launches, mpmm_ff_cuda.launches,
            mpmm_ff_cuda.x32_launches) == (before[0], before[1] + 1, before[2], before[3] + 2)
    atol = k * 2.0**-22 * xmax * 127
    exp = ref.mpmm_ref(x, w_data, w_scale, w_bits=w_bits)
    torch.testing.assert_close(cf, exp, atol=atol * w_scale.max().item(), rtol=1e-5)
    torch.testing.assert_close(ff, exp, atol=atol * w_scale.max().item(), rtol=1e-5)
    del exp
    torch.testing.assert_close(acc, ref.mpmm_ff_ref(x, w_data, w_bits=w_bits), atol=atol,
                               rtol=1e-5)
    assert torch.equal(cf, ops.mpmm(x, w_data, w_scale, w_bits=w_bits, dataflow="cf"))
    assert torch.equal(acc, mpmm_ff_cuda(x, w_data, w_bits=w_bits))


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", X32_SERVING)
def test_mpmm_x32_entries_match_plain_at_serving_shapes(dev, w_bits, m, k, n):
    _x32_check(dev, m, k, n, w_bits, m * 11 + k + n)


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("layer", [name for name, *_ in _resnet18_shapes()])
def test_mpmm_x32_entries_match_plain_at_resnet18_convs(dev, w_bits, layer):
    _, m, k, n = next(s for s in _resnet18_shapes() if s[0] == layer)
    if w_bits == 4 and k % 2:
        pytest.skip(f"{layer}: K={k} is odd and int4 packs K in pairs (init_network raises)")
    _x32_check(dev, m, k, n, w_bits, m + k * 3 + n)


@pytest.mark.parametrize("m,k,n", [(1, 16, 1), (37, 130, 200), (300, 1100, 130),
                                   (65, 520, 63), (129, 147, 64), (5, 3000, 72),
                                   (9, 4100, 136)])
def test_mpmm_x32_entries_at_ragged_edges(dev, m, k, n):
    """Ragged M, N and K against the 8- and 64-row tiles, the 32-row K step
    (128 at 8 rows), the K split and the 512-row stages; K % 4 != 0
    (x by 4-byte copies) and N % 16 != 0 (weights by byte loads: the f32
    kernel takes any N in both orders)."""
    for w_bits in (4, 8) if k % 2 == 0 else (8,):
        _x32_check(dev, m, k, n, w_bits, m * 13 + k + n)


def test_mpmm_x32_off_16_byte_rows(dev):
    """x and the weights at storage offsets of one element: rows off 16
    bytes though K % 4 == N % 16 == 0, so x lands by 4-byte copies and the
    weights by byte loads, with the same result as aligned copies."""
    m, k, n = 96, 1024, 256
    g = torch.Generator().manual_seed(9)
    x0 = torch.randn(m, k, generator=g)
    wd0, ws = ops.pack_weights(torch.randn(k, n, generator=g) / 32.0, 8)
    x = torch.empty(m * k + 1, device=dev)[1:].view(m, k)
    x.copy_(x0)
    wd = torch.empty(k * n + 1, dtype=torch.int8, device=dev)[1:].view(k, n)
    wd.copy_(wd0)
    assert x.data_ptr() % 16 and wd.data_ptr() % 16
    ws = ws.to(dev)
    aligned = (x0.to(dev), wd0.to(dev))
    assert torch.equal(mpmm_cuda(x, wd, ws, w_bits=8), mpmm_cuda(*aligned, ws, w_bits=8))
    assert torch.equal(mpmm_ff_cuda(x, wd, w_bits=8), mpmm_ff_cuda(*aligned, w_bits=8))


@pytest.mark.parametrize("w_bits", [4, 8])
def test_mpmm_x32_extreme_x(dev, w_bits):
    """The TF32 split at the ends of f32's range: a finite x near FLT_MAX,
    whose hi would round to inf, times a zero weight row gives 0 (not
    inf * 0 = NaN); an infinite x times a weight row of ones gives inf in
    every column (its lo is 0, not inf - inf); subnormal and zero x give
    the plain version's values.  Both orders."""
    m, k, n = 16, 1024, 128
    g = torch.Generator().manual_seed(11)
    lim = 7 if w_bits == 4 else 127
    wi = torch.randint(-lim, lim + 1, (k, n), generator=g, dtype=torch.int8)
    wi[0] = 0
    wi[1] = 1
    x = torch.randn(m, k, generator=g)
    x[:, 0] = 3.4028e38
    x[:, 1] = float("inf")
    x[:, 2] = 1e-40
    x[:, 3] = 0.0
    wd = (pack_int4(wi, dim=0) if w_bits == 4 else wi).to(dev)
    ws = torch.full((1, n), 0.01).to(dev)
    x = x.to(dev)
    cf = mpmm_cuda(x, wd, ws, w_bits=w_bits)
    ff = mpmm_ff_cuda(x, wd, w_bits=w_bits)
    assert bool(torch.isposinf(cf).all()) and bool(torch.isposinf(ff).all())
    x[:, 1] = 0.0
    atol = k * 2.0**-22 * x[:, 4:].abs().max().item() * lim
    torch.testing.assert_close(mpmm_cuda(x, wd, ws, w_bits=w_bits),
                               ref.mpmm_ref(x, wd, ws, w_bits=w_bits), atol=atol * 0.01,
                               rtol=1e-5)
    torch.testing.assert_close(mpmm_ff_cuda(x, wd, w_bits=w_bits),
                               ref.mpmm_ff_ref(x, wd, w_bits=w_bits), atol=atol, rtol=1e-5)


def test_dispatch_f32_card_cpu_meta(dev):
    """f32 activations through ``ops.mpmm``'s three routes: the card
    launches the f32 entry, the CPU runs the plain version, meta gets the
    contract; f32 out of all three."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(96, 3072, generator=g)
    wd, ws = ops.pack_weights(torch.randn(3072, 1024, generator=g) / 55.4, 4)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (x, wd, ws)]
    before = (mpmm_cuda.launches, mpmm_cuda.x32_launches)
    got = ops.mpmm(x.to(dev), wd.to(dev), ws.to(dev), w_bits=4)
    assert (mpmm_cuda.launches, mpmm_cuda.x32_launches) == (before[0], before[1] + 1)
    plain = ops.mpmm(x, wd, ws, w_bits=4)
    contract = ops.mpmm(*meta, w_bits=4)
    assert mpmm_cuda.x32_launches == before[1] + 1
    assert contract.is_meta and contract.shape == got.shape == plain.shape
    assert contract.dtype == got.dtype == plain.dtype == torch.float32
    atol = 3072 * 2.0**-22 * x.abs().max().item() * 7 * ws.max().item()
    torch.testing.assert_close(got.cpu(), plain, atol=atol, rtol=1e-5)


# The bf16 entries' outputs on fixed inputs, as sha256 digests of their
# bytes: the CF entry at the 8-row tile (with and without a K split), the
# 64- and 128-row tiles and its f32-out twin, and the FF order.  The f32
# activations' entries were added beside them without touching them, so
# they give the bits they gave before (the digests were taken on the H100
# from the tree before those entries were added).
BF16_DIGEST_CASES = [("cf", 4, 8, 3072, 8192), ("cf", 8, 5, 8192, 3072),
                     ("cf", 8, 40, 3072, 3072), ("cf", 4, 256, 3072, 3072),
                     ("f32", 8, 256, 2048, 3072), ("ff", 8, 1568, 2304, 256),
                     ("ff", 4, 392, 4608, 512)]
BF16_DIGESTS = {
    "cf w4 M=8 K=3072 N=8192":
        "d20ecb5ccee30e3afe79252d48dd21a9ae082e9db51e18dae3bc030844ebe1e6",
    "cf w8 M=5 K=8192 N=3072":
        "94ac4a6c517e42edfbfbf1124200451528a4237dd2ec2596a39ae79f510b4350",
    "cf w8 M=40 K=3072 N=3072":
        "60223ae5a2bb9e134b39a6d920af84a7f2afaeea90e4201f63abb0796643cb16",
    "cf w4 M=256 K=3072 N=3072":
        "c46a1185eb039c176d6c3106c3ecc6224eea44d7b7ae1b69398d378bd56df72b",
    "f32 w8 M=256 K=2048 N=3072":
        "ae0bdeedb74dd79dd52889cd70f36ae9f2f0203e3b86d83e62ae6041918f72f0",
    "ff w8 M=1568 K=2304 N=256":
        "e7f3e67039edcf40a33629146741538295a66e896ea8c9d467dcd33ba33661e6",
    "ff w4 M=392 K=4608 N=512":
        "5923335f76159f9eedcacf318ba9bdf3ffe0f2625538170961e982a4bd5f7e81",
}


def bf16_entry_digests(dev) -> dict:
    import hashlib

    out = {}
    for entry, w_bits, m, k, n in BF16_DIGEST_CASES:
        rng = np.random.default_rng(m + k + n)
        wd, ws = ops.pack_weights(
            torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) / math.sqrt(k)), w_bits)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
        x, wd, ws = x.to(dev), wd.to(dev), ws.to(dev)
        if entry == "ff":
            y = mpmm_ff_cuda(x, wd, w_bits=w_bits)
        else:
            y = mpmm_cuda(x, wd, ws, w_bits=w_bits,
                          out_dtype=torch.float32 if entry == "f32" else torch.bfloat16)
        raw = y.cpu().contiguous().view(torch.uint8).numpy().tobytes()
        out[f"{entry} w{w_bits} M={m} K={k} N={n}"] = hashlib.sha256(raw).hexdigest()
    return out


def test_mpmm_bf16_entries_keep_their_bits(dev):
    assert bf16_entry_digests(dev) == BF16_DIGESTS


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


def test_run_network_f32_on_card_matches_cpu(dev):
    """The CNN path in float32, as ``launch.cnn`` runs it on the card: the
    f32 entries in both orders, within f32 summation-order error of the
    CPU's plain versions (1e-4 of the output's largest value, as the CPU
    run is held to JAX's); the same FF / CF decisions."""
    from repro_torch.core.dataflow import ConvLayer
    from repro_torch.models import cnn

    layers = [ConvLayer("a", 3, 16, 7, 32, 32, 2, 3), ConvLayer("b", 16, 32, 3, 16, 16, 1, 1),
              ConvLayer("c", 32, 48, 1, 16, 16, 2, 0), ConvLayer("d", 48, 64, 3, 6, 6, 1, 1)]
    gen = torch.Generator().manual_seed(1)
    params = [ops.conv_pack_weights(torch.randn(l.k, l.k, l.cin, l.cout, generator=gen)
                                    / (l.k * l.cin ** 0.5), 8) for l in layers]
    x = torch.randn(2, 24, 24, 3, generator=gen)
    for strategy in ("ff", "cf", "mixed"):
        before = (mpmm_cuda.x32_launches, mpmm_ff_cuda.x32_launches)
        exp, dec = cnn.run_network("t", x, params, layers, strategy=strategy, device="cpu")
        got, dec_card = cnn.run_network(
            "t", x.to(dev), [(a.to(dev), b.to(dev)) for a, b in params], layers,
            strategy=strategy, device=dev)
        assert dec_card == dec and got.dtype == torch.float32
        launched = (mpmm_cuda.x32_launches - before[0], mpmm_ff_cuda.x32_launches - before[1])
        assert sum(launched) == len(layers) and (strategy != "ff" or launched[0] == 0)
        big = exp.abs().max().item()
        torch.testing.assert_close(got.cpu(), exp, atol=1e-4 * big, rtol=1e-4)


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
def _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d, dtype=torch.bfloat16):
    shape = (n_layers, n_pages, ps, hkv, d)
    if kv_bits == 16:
        kp = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
        vp = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
        return kp.to(dev), vp.to(dev), None, None
    kf = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    kq, ks = ops.quantize_kv(kf.reshape(-1, *shape[2:]), kv_bits)
    vq, vs = ops.quantize_kv(vf.reshape(-1, *shape[2:]), kv_bits)
    r = lambda t: t.reshape(n_layers, n_pages, *t.shape[1:]).to(dev)  # noqa: E731
    return r(kq), r(vq), r(ks), r(vs)


def _tokens(rng, dev, kv_bits, lead, d, dtype=torch.bfloat16):
    x = torch.from_numpy(rng.normal(size=(*lead, d)).astype(np.float32))
    if kv_bits == 16:
        return x.to(dtype).to(dev), None
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


def _paged_case(rng, dev, kv_bits, b, hkv, g, d, ps, w, lengths, n_layers=2):
    """Pools, shuffled tables, lengths, q and the step's own token."""
    n_pages = b * w + 3
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    nk, nks = _tokens(rng, dev, kv_bits, (b, hkv), d)
    nv, nvs = _tokens(rng, dev, kv_bits, (b, hkv), d)
    return q, (kp, vp, ks, vs, tables, lens, n_layers - 1, nk, nv, nks, nvs)


def _paged_check(q, args, kv_bits, window):
    """The kernel against the plain version; two calls give the same bits."""
    got = ops.paged_mqa_decode(q, *args, kv_bits=kv_bits, window=window)
    exp = ref.paged_mqa_decode_ref(q, *args, sm_scale=1 / math.sqrt(q.shape[-1]),
                                   kv_bits=kv_bits, window=window)
    _close(got, exp)
    assert torch.equal(got, ops.paged_mqa_decode(q, *args, kv_bits=kv_bits, window=window))
    return got


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 256])
def test_paged_decode_kernel_repeats_bits(dev, kv_bits, window):
    """llama3.2-3b's serving shape (8 x 3 x 128, ps 16, ragged rows near
    1024, split across blocks and merged by a second launch): within the
    tolerance of the plain version, and two calls give the same bits."""
    from repro_torch.kernels import paged_decode as pd

    rng = np.random.default_rng(kv_bits + (window or 0))
    q, args = _paged_case(rng, dev, kv_bits, 8, 8, 3, 128, 16, 65,
                          [1024 - (i % 3) for i in range(8)])
    _paged_check(q, args, kv_bits, window)
    assert pd.decode_plan(8, 8, 3, 128, 65, 16, window)["splits"] > 1


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("g", [4, 8])
@pytest.mark.parametrize("d", [112, 256])
def test_paged_decode_kernel_one_kv_head_wide_groups(dev, kv_bits, g, d):
    """One kv head at G 4 and 8 (several query groups a head), D 112 (kv4:
    56-byte rows, 8-byte copies) and D 256 (2 units a lane): gemma3-1b's
    head shape and its window of 1024 among the rows."""
    rng = np.random.default_rng(kv_bits + g + d)
    lengths = [0, 5, 300, 777, 1100]
    q, args = _paged_case(rng, dev, kv_bits, 5, 1, g, d, 16, 70, lengths)
    for window in (None, 1024):
        _paged_check(q, args, kv_bits, window)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("ps", [16, 8])
def test_paged_decode_kernel_lengths_at_tile_page_and_split_edges(dev, kv_bits, window, ps):
    """Lengths at 8-token tiles, pages and the planned splits, each +-1, and
    a full table; rows past their length hold stale pages."""
    from repro_torch.kernels import paged_decode as pd

    hkv, g, d, w = 2, 3, 64, 40
    per = pd.decode_plan(1, hkv, g, d, w, ps, window)["per_split"]
    edges = sorted({e + o for e in (8, 16, ps, 2 * ps, per, 2 * per, 3 * per, w * ps - 1)
                    for o in (-1, 0, 1)} | {0, w * ps})
    lengths = [n for n in edges if 0 <= n <= w * ps]
    rng = np.random.default_rng(kv_bits + ps + (window or 0))
    q, args = _paged_case(rng, dev, kv_bits, len(lengths), hkv, g, d, ps, w, lengths)
    assert pd.decode_plan(len(lengths), hkv, g, d, w, ps, window)["per_split"] <= per
    _paged_check(q, args, kv_bits, window)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_paged_decode_kernel_window_1024_at_ctx_2048(dev, kv_bits):
    """A window of 1024 at context 2048: only the last 1023 cached positions
    and the new token count; the window start falls mid-page and mid-tile."""
    rng = np.random.default_rng(kv_bits)
    lengths = [2048, 2047, 2040, 1500]
    q, args = _paged_case(rng, dev, kv_bits, 4, 4, 2, 128, 16, 129, lengths)
    _paged_check(q, args, kv_bits, 1024)


@pytest.mark.parametrize("kv_bits,d", [(16, 34), (8, 40), (4, 8), (16, 256)])
def test_paged_decode_kernel_odd_widths(dev, kv_bits, d):
    """bf16 rows of D = 2 mod 4 (half a unit at the end), D 40 (a 16-dim
    product step half past the row), D 8 at int4 (4-byte rows), bf16 rows of
    D 256 (512-byte rows, 32 copies each), at page size 4."""
    rng = np.random.default_rng(d)
    q, args = _paged_case(rng, dev, kv_bits, 3, 2, 2, d, 4, 30, [0, 57, 120])
    for window in (None, 21):
        _paged_check(q, args, kv_bits, window)


def test_paged_decode_kernel_entry_point_refuses_what_it_does_not_take(dev):
    """The C entry point refuses a split that does not cover the table, a
    split of a ragged tile, more than 64 splits, query groups that do not
    match G, and head dims past 256; the wrapper raises for the last."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(0)
    q, args = _paged_case(rng, dev, 8, 2, 2, 3, 64, 16, 4, [20, 64])
    kp, vp, ks, vs, tables, lens, layer, nk, nv, nks, nvs = args
    qg = q.reshape(2, 2, 3, 64)
    out = torch.empty_like(qg)
    part = torch.empty(2 * 2 * 3 * 64 * 68, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(n_groups, splits, per, d=64):
        return _build.lib().paged_decode_bf16(
            qg.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vs.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), nk.data_ptr(), nv.data_ptr(), nks.data_ptr(),
            nvs.data_ptr(), out.data_ptr(), part.data_ptr(), 2, layer, kp.shape[1], 16,
            2, 3, d, 4, 8, 0, n_groups, splits, per, 0.125, stream)

    assert launch(1, 2, 32) == 0
    torch.cuda.synchronize()
    for bad in ((1, 1, 32), (1, 2, 28), (1, 65, 8), (2, 2, 32), (1, 2, 32, 264)):
        assert launch(*bad) != 0, bad
    wide = torch.zeros(2, 2, 3, 264, dtype=torch.bfloat16, device=dev)
    pool = torch.zeros(2, 8, 16, 2, 264, dtype=torch.bfloat16, device=dev)
    new = torch.zeros(2, 2, 264, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dims up to 256"):
        paged_mqa_decode_cuda(wide, pool, pool, None, None, tables, lens, 0, new, new, None,
                              None, kv_bits=16, sm_scale=1.0)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("hkv,w,lengths", [(6, 12, [0, 1, 37, 100, 192]),
                                           (24, 40, [575, 600, 640, 320, 1])])
def test_paged_decode_kernel_one_query_head_per_kv_head(dev, kv_bits, window, hkv, w, lengths):
    """G = 1 (multi-head attention, no query groups) at D 64: several kv
    heads with ragged rows, and musicgen-medium's 24 heads at its serving
    context (64 prefix + 512 prompt tokens and more)."""
    rng = np.random.default_rng(kv_bits + hkv + (window or 0))
    q, args = _paged_case(rng, dev, kv_bits, 5, hkv, 1, 64, 16, w, lengths)
    _paged_check(q, args, kv_bits, window)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 19])
@pytest.mark.parametrize("c", [1, 5, 32])
def test_paged_prefill_kernel_one_query_head_per_kv_head(dev, kv_bits, window, c):
    """G = 1 at D 64 (musicgen-medium's attention) over 6 kv heads: chunks
    and a verify-sized window with ragged q_lens; two runs give the same
    bits."""
    rng = np.random.default_rng(kv_bits * 10 + c)
    b, n_layers, ps, hkv, d, w = 3, 2, 8, 6, 64, 12
    n_pages = b * w
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor([0, 13, 60], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([c, max(c - 2, 0), (c + 1) // 2], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
    got = ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits,
                                    window=window)
    _close(got, exp)
    assert torch.equal(got, ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window))


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_paged_prefill_kernel_at_paligemma_verify(dev, kv_bits):
    """A spec verify window (C 5, q_lens 1-5 and a padding row) at
    paligemma-3b's heads: 1 kv head, G 8, D 256, contexts of 256 prefix +
    512 prompt tokens and more."""
    rng = np.random.default_rng(70 + kv_bits)
    b, n_layers, ps, hkv, g, d, c = 8, 2, 16, 1, 8, 256, 5
    ctx_list = [768, 800, 790, 769, 777, 783, 795, 0]
    w = -(-(max(ctx_list) + c) // ps)
    n_pages = b * w + 2
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    q_lens = torch.tensor([1, 2, 3, 4, 5, 5, 3, 0], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
    got = ops.paged_mqa_verify(*args, kv_bits=kv_bits)
    torch.cuda.synchronize()
    exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits)
    live = torch.arange(c, device=dev)[None, :] < q_lens[:, None]
    _close(got[live], exp[live])
    assert torch.equal(got, ops.paged_mqa_verify(*args, kv_bits=kv_bits))


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
def test_paged_prefill_kernel_at_the_verify_shape(dev, kv_bits):
    """A speculative verify window at llama3.2-3b's heads: B = 8, C = 5
    (spec_k 4 + 1), q_lens 1-5 (n_draft + 1) with a padding row at 0,
    round-start contexts 512-1024; two runs give the same bits."""
    rng = np.random.default_rng(40 + kv_bits)
    b, n_layers, ps, hkv, g, d, c = 8, 2, 16, 8, 3, 128, 5
    ctx_list = [512, 1024, 700, 513, 1000, 640, 901, 0]
    w = -(-(max(ctx_list) + c) // ps)
    n_pages = b * w + 2
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    q_lens = torch.tensor([1, 2, 3, 4, 5, 5, 3, 0], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
    q = q.to(torch.bfloat16).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
    got = ops.paged_mqa_verify(*args, kv_bits=kv_bits)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits)
    live = torch.arange(c, device=dev)[None, :] < q_lens[:, None]
    _close(got[live], exp[live])
    assert torch.equal(got, ops.paged_mqa_verify(*args, kv_bits=kv_bits))


def near_cdf_boundary(logits, temps, top_k, top_p, u, eps=1e-6) -> torch.Tensor:
    """[B] bool: rows whose uniform lies within ``eps`` of a boundary of the
    sampled distribution's CDF (float64 on the CPU), where an f32 sum in
    another order may pick the neighbouring token."""
    probs = ops.sampling_probs(logits.cpu(), temps.cpu(), top_k.cpu(), top_p.cpu()).double()
    cdf = torch.cumsum(probs / probs.sum(-1, keepdim=True), dim=-1)
    return ((cdf - u.cpu().double()[:, None]).abs() < eps).any(dim=-1)


def test_sample_tokens_on_card_match_cpu(dev):
    """llama3.2-3b's vocabulary (128256, 9 padding columns at -1e30), B = 8,
    temperature 0.8, top_k 50, top_p 0.95, on identical f32 logits: keys and
    uniforms are bit-equal on the card and the CPU, and so are the tokens,
    except where a uniform lies within 1e-6 of a CDF boundary."""
    rng = np.random.default_rng(3)
    b, v = 8, 128256
    lg = torch.from_numpy((rng.standard_normal((b, v)) * 3).astype(np.float32))
    lg[:, v - 9:] = -1e30
    seeds = torch.from_numpy(rng.integers(0, 2**32, b))
    pos = torch.from_numpy(rng.integers(0, 4096, b))
    temps = torch.full((b,), 0.8)
    top_k = torch.full((b,), 50)
    top_p = torch.full((b,), 0.95)
    keys = ops.sample_keys(seeds, pos)
    keys_card = ops.sample_keys(seeds.to(dev), pos.to(dev))
    assert torch.equal(keys_card.cpu(), keys)
    u = prng.uniform(keys)
    assert torch.equal(prng.uniform(keys_card).cpu(), u)
    want = ops.sample_tokens(lg, keys, temps, top_k, top_p)
    got = ops.sample_tokens(lg.to(dev), keys_card, temps.to(dev), top_k.to(dev),
                            top_p.to(dev)).cpu()
    near = near_cdf_boundary(lg, temps, top_k, top_p, u)
    assert torch.equal(got[~near], want[~near])
    greedy = ops.sample_tokens(lg.to(dev), keys_card, torch.zeros(b, device=dev))
    assert torch.equal(greedy.cpu(), torch.argmax(lg, dim=-1).to(torch.int32))


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
    q = torch.zeros(1, 1, 2, 1, 264, dtype=torch.bfloat16, device=dev)
    pool = torch.zeros(1, 2, 4, 1, 264, dtype=torch.bfloat16, device=dev)
    chunk = torch.zeros(1, 1, 2, 264, dtype=torch.bfloat16, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dims up to 256"):
        paged_mqa_prefill_cuda(q, pool, pool, None, None, one.reshape(1, 1), one, one, 0,
                               chunk, chunk, None, None, kv_bits=16, sm_scale=1.0)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 1024])
@pytest.mark.parametrize("d", [160, 192, 256])
def test_paged_prefill_kernel_wide_heads(dev, kv_bits, window, d):
    """gemma3-1b's heads (Hkv 1, G 4) at D 256, and at D 160 and 192, which
    pad to 256: a 128-token chunk and a verify window (C 5) over contexts up
    to 1300, where a window of 1024 binds, ragged q_lens and a padding row;
    two runs give the same bits."""
    rng = np.random.default_rng(d + kv_bits + (window or 0))
    b, n_layers, ps, hkv, g = 4, 2, 16, 1, 4
    ctx_list = [1300, 1100, 700, 0]
    for c, ql in ((128, [128, 100, 1, 0]), (5, [5, 3, 1, 0])):
        w = -(-(max(ctx_list) + c) // ps)
        n_pages = b * w + 2
        kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d)
        tables = torch.from_numpy(
            rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
        q_lens = torch.tensor(ql, dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
        q = q.to(torch.bfloat16).to(dev)
        ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
        cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d)
        args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
        before = paged_mqa_prefill_cuda.launches
        got = ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window)
        torch.cuda.synchronize()
        assert paged_mqa_prefill_cuda.launches == before + 1
        assert torch.isfinite(got.float()).all()
        exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits,
                                        window=window)
        live = torch.arange(c, device=dev)[None, :] < q_lens[:, None]
        _close(got[live], exp[live])
        assert torch.equal(got, ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window))


# ------------------------------------ paged attention, the bf16 kernels' bits
# sha256 of the bf16 instantiations' outputs on fixed inputs (numpy draws,
# quantized on the CPU), taken on the H100 before the f32 instantiations were
# redesigned beside them: a change to the f32 paths that moves a bf16 bit
# fails here.  Update them only for a change meant to move the bf16 bits.
# Decode: (kv_bits, hkv, g, d, ps, w, lengths, window); prefill: (kv_bits,
# hkv, g, d, c, ctx, q_lens, window): llama3.2-3b's heads (split rows, a
# window, a chunk and a verify window), gemma3-1b's and paligemma-3b's D 256,
# D 192 and 40 (padded), and the reduced configs' small heads.
_LLAMA_LENS = [1022, 1023, 1024, 1022, 0, 1, 17, 600]
BF16_PAGED_DECODE_CASES = [
    (kv, *heads, lens, win)
    for kv in (4, 8, 16)
    for heads, lens, wins in (
        ((8, 3, 128, 16, 65), _LLAMA_LENS, (None, 256)),
        ((2, 2, 64, 8, 9), [0, 1, 19, 41, 72], (None, 21)),
        ((1, 8, 256, 16, 50), [784, 782, 783, 0], (None,)),
        ((1, 4, 256, 16, 130), [2048, 2047, 1300, 5], (1024,)),
        ((2, 3, 192, 16, 20), [300, 7, 160], (None,)))
    for win in wins]
BF16_PAGED_PREFILL_CASES = [
    (kv, *case)
    for kv in (4, 8, 16)
    for case in (
        (8, 3, 128, 128, [256, 200, 384, 128], [128, 127, 64, 1], None),
        (8, 3, 128, 5, [512, 1024, 700, 0], [1, 5, 3, 0], None),
        (8, 3, 128, 5, [512, 1024, 700, 0], [1, 5, 3, 0], 200),
        (1, 4, 256, 128, [1536, 1480, 1300, 1536], [128, 127, 64, 1], 1024),
        (1, 8, 256, 5, [768, 800, 790, 0], [5, 2, 4, 0], None),
        (2, 2, 40, 32, [40, 0, 97], [32, 31, 16], 19),
        (1, 4, 192, 32, [300, 97, 0], [32, 9, 1], None))]
BF16_PAGED_DIGESTS = {
    "decode kv4 8x3x128 ps16 w65 [1022, 1023, 1024, 1022, 0, 1, 17, 600] window=None":
        "db68749e890b7a36c949f637e6a88305f95261b0c44b356297828e7b73d2722c",
    "decode kv4 8x3x128 ps16 w65 [1022, 1023, 1024, 1022, 0, 1, 17, 600] window=256":
        "fe9d52ac875dc4db14ff07eaddbd98324cac494e623a5851c02ec3ff0ee9dc83",
    "decode kv4 2x2x64 ps8 w9 [0, 1, 19, 41, 72] window=None":
        "36415b9ca0331279301ab3fa16594cb8a14c8200880dc2f6b8b330fad748bf0f",
    "decode kv4 2x2x64 ps8 w9 [0, 1, 19, 41, 72] window=21":
        "04a14647de94767ae4f0d795c352d796da0738033bbf9f543a210ca300f728f2",
    "decode kv4 1x8x256 ps16 w50 [784, 782, 783, 0] window=None":
        "5cec045acc5b038573db2b77fabdb340197cce68d80d1f6c0b38011ca46c8327",
    "decode kv4 1x4x256 ps16 w130 [2048, 2047, 1300, 5] window=1024":
        "ff1b39642495595f2f1f249f5b677b7f7ed31f0dc71f354ce0a08889ddb444bb",
    "decode kv4 2x3x192 ps16 w20 [300, 7, 160] window=None":
        "b7446c8daadb61581000ef12ab9e38d23972777ead7b779feddd331944964c00",
    "decode kv8 8x3x128 ps16 w65 [1022, 1023, 1024, 1022, 0, 1, 17, 600] window=None":
        "831db564264e9a5e599446ba096c3aa433abcf404f3b295ac3aff9ef8253b617",
    "decode kv8 8x3x128 ps16 w65 [1022, 1023, 1024, 1022, 0, 1, 17, 600] window=256":
        "61dc7d4fd4ad9580ae2ea1d3f8ad43a7be27f326ba2050b446e38bccc718ee92",
    "decode kv8 2x2x64 ps8 w9 [0, 1, 19, 41, 72] window=None":
        "d1da5c08e78496663f9fdc3fcb36c6716f7029c1cd76d7530ac97e537bd603a1",
    "decode kv8 2x2x64 ps8 w9 [0, 1, 19, 41, 72] window=21":
        "f415aeea0ce627338690df604b089945bf11db37f8e03296d724205b8460d3c9",
    "decode kv8 1x8x256 ps16 w50 [784, 782, 783, 0] window=None":
        "7e337e888c401f4c578675eece1823aa8c47829c76efdd934b4eaa2b616b732b",
    "decode kv8 1x4x256 ps16 w130 [2048, 2047, 1300, 5] window=1024":
        "124689725a97696817469eeb98a326320f7cb8476e14e1dd8357f9a663379433",
    "decode kv8 2x3x192 ps16 w20 [300, 7, 160] window=None":
        "9695c301f2f3dd2a5e52e58a34335efc7427a6c6655d85edb270e8e27e782da2",
    "decode kv16 8x3x128 ps16 w65 [1022, 1023, 1024, 1022, 0, 1, 17, 600] window=None":
        "80222b144002a8b868ee751ac3668796d585cc52ea08602b81a7c3d453551280",
    "decode kv16 8x3x128 ps16 w65 [1022, 1023, 1024, 1022, 0, 1, 17, 600] window=256":
        "b0c554574a6120d99fa23c17d4820762ff614fbd055e46ffdaa0cf4400bd438e",
    "decode kv16 2x2x64 ps8 w9 [0, 1, 19, 41, 72] window=None":
        "86d0501ea3c6023966b675923e20f8c710fe7ebd37fa8149f940060a08f75864",
    "decode kv16 2x2x64 ps8 w9 [0, 1, 19, 41, 72] window=21":
        "7394d5d763bf1a3ff6828b300d942c3c1192b7ef6b6c1441057332de94a89b72",
    "decode kv16 1x8x256 ps16 w50 [784, 782, 783, 0] window=None":
        "dfc2b44b8b7485a14dc5a3636fcb8fdef47eec75928d1e62f7dcaab096c31bd9",
    "decode kv16 1x4x256 ps16 w130 [2048, 2047, 1300, 5] window=1024":
        "05c685e1c28cf4b36b9e042c515d868aca7c2877974a4109e9bcc03077be412d",
    "decode kv16 2x3x192 ps16 w20 [300, 7, 160] window=None":
        "7ead7138a53526110880bdd617850f674a7638f5b2079626e5ddedd823e27421",
    "prefill kv4 8x3x128 C128 ctx[256, 200, 384, 128] q[128, 127, 64, 1] window=None":
        "0543da31adc0f831a88de88b4fe0c27b3f62e5327444e8239d1899595a160408",
    "prefill kv4 8x3x128 C5 ctx[512, 1024, 700, 0] q[1, 5, 3, 0] window=None":
        "f8a709de0de1c5b4b2a4fc4d5ad5c598e98e61aa2ef7a6ea4d17cff98ef34793",
    "prefill kv4 8x3x128 C5 ctx[512, 1024, 700, 0] q[1, 5, 3, 0] window=200":
        "ae3566d89102d95e3f8cc804bbc7411f48526457dfb004c16cb29ead5975fb6a",
    "prefill kv4 1x4x256 C128 ctx[1536, 1480, 1300, 1536] q[128, 127, 64, 1] window=1024":
        "68816fa3aa60cc5b0875fe07bef71564295abf0eba7c79b304af3791a46046d5",
    "prefill kv4 1x8x256 C5 ctx[768, 800, 790, 0] q[5, 2, 4, 0] window=None":
        "711abe648f922d49723fd4d871f4067f041f93cbb7072d5535ada921aa075bfe",
    "prefill kv4 2x2x40 C32 ctx[40, 0, 97] q[32, 31, 16] window=19":
        "1b75dcad5a6a0225f8471cada409179d625e260a5219b0a0c9bdaa443b1a96e3",
    "prefill kv4 1x4x192 C32 ctx[300, 97, 0] q[32, 9, 1] window=None":
        "fbf9784d5ccde5fd1fb6fac4a83beb591e39d8e19c7aa95dd9c63d19f756e0a0",
    "prefill kv8 8x3x128 C128 ctx[256, 200, 384, 128] q[128, 127, 64, 1] window=None":
        "f993b6853566614e4a504255aae620f43698292c6a8befe56fb42890088b4f59",
    "prefill kv8 8x3x128 C5 ctx[512, 1024, 700, 0] q[1, 5, 3, 0] window=None":
        "47742bb11ae913cd280524c0cd731e762ea9f7257d428e91ee32c5e7ec9467b5",
    "prefill kv8 8x3x128 C5 ctx[512, 1024, 700, 0] q[1, 5, 3, 0] window=200":
        "cd1da8cdc4665a56db5f1b216722bf37495c13a4288086e3fd75163871daca01",
    "prefill kv8 1x4x256 C128 ctx[1536, 1480, 1300, 1536] q[128, 127, 64, 1] window=1024":
        "bd8eb4d051cce8b9bf7df0442936b451ca7f36b84101f0fee65f994c09f2b046",
    "prefill kv8 1x8x256 C5 ctx[768, 800, 790, 0] q[5, 2, 4, 0] window=None":
        "a911cba4896e25da54ade2846fc7da948d9643caebddc6543ecd4cddd1c000da",
    "prefill kv8 2x2x40 C32 ctx[40, 0, 97] q[32, 31, 16] window=19":
        "b0be66644b01941cd40e81d84a27dbaeaffa2991b8f577cc8ae3210f7f63e19f",
    "prefill kv8 1x4x192 C32 ctx[300, 97, 0] q[32, 9, 1] window=None":
        "92168a4ae3f4d320924ed1db02783844465767e10049acf7d97849d72320faee",
    "prefill kv16 8x3x128 C128 ctx[256, 200, 384, 128] q[128, 127, 64, 1] window=None":
        "59ae1b04a0297bc211ef9d1172cf143e044dce2d7ffed46badffd8057cbf12d5",
    "prefill kv16 8x3x128 C5 ctx[512, 1024, 700, 0] q[1, 5, 3, 0] window=None":
        "ee45e816bfb9e4cab73754b82b42db80ee7c92ee7f96e89e9f69d97d5ac4ec29",
    "prefill kv16 8x3x128 C5 ctx[512, 1024, 700, 0] q[1, 5, 3, 0] window=200":
        "31f33959b8d4fbbf7904b8e842509df2399c1260a29163031f434e2c23547ffa",
    "prefill kv16 1x4x256 C128 ctx[1536, 1480, 1300, 1536] q[128, 127, 64, 1] window=1024":
        "54bf80be12760a6cfc4c16d6b21c0cce6d3975b465ef2578f6b4cfb1c59471e5",
    "prefill kv16 1x8x256 C5 ctx[768, 800, 790, 0] q[5, 2, 4, 0] window=None":
        "4deed4ebd1b115eecf8a5a4add3ddfe9d1cfb926b5cab9ca3959484d17c8c603",
    "prefill kv16 2x2x40 C32 ctx[40, 0, 97] q[32, 31, 16] window=19":
        "ca18f7f22479b8c1f9d86f429d14fb259385cdfec98c621c89330117cc8e4086",
    "prefill kv16 1x4x192 C32 ctx[300, 97, 0] q[32, 9, 1] window=None":
        "cfaba07ccfb8e5cd444a3fc3cac2faa0a3fc5d3bfb7f988339b54e0e05b346ce",
}


def paged_bf16_digests(dev) -> dict:
    """sha256 of each fixed case's bf16 output (decode, then prefill)."""
    import hashlib

    def digest(t):
        return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()

    out = {}
    for i, (kv, hkv, g, d, ps, w, lens, win) in enumerate(BF16_PAGED_DECODE_CASES):
        rng = np.random.default_rng(1000 + i)
        q, args = _paged_case(rng, dev, kv, len(lens), hkv, g, d, ps, w, lens)
        out[f"decode kv{kv} {hkv}x{g}x{d} ps{ps} w{w} {lens} window={win}"] = digest(
            ops.paged_mqa_decode(q, *args, kv_bits=kv, window=win))
    for i, (kv, hkv, g, d, c, ctx_list, qls, win) in enumerate(BF16_PAGED_PREFILL_CASES):
        rng = np.random.default_rng(2000 + i)
        b, ps = len(ctx_list), 16
        w = -(-(max(ctx_list) + c) // ps)
        n_pages = b * w + 2
        kp, vp, ks, vs = _pools(rng, dev, kv, 2, n_pages, ps, hkv, d)
        tables = torch.from_numpy(
            rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
        q_lens = torch.tensor(qls, dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32))
        q = q.to(torch.bfloat16).to(dev)
        ck, cks = _tokens(rng, dev, kv, (b, c, hkv), d)
        cv, cvs = _tokens(rng, dev, kv, (b, c, hkv), d)
        got = ops.paged_mqa_prefill(q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks,
                                    cvs, kv_bits=kv, window=win)
        out[f"prefill kv{kv} {hkv}x{g}x{d} C{c} ctx{ctx_list} q{qls} window={win}"] = digest(got)
    return out


def test_paged_bf16_kernels_keep_their_bits(dev):
    assert paged_bf16_digests(dev) == BF16_PAGED_DIGESTS


# ------------------------------------- paged attention, f32 instantiations
F32_ATTN_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 summation order only


def _launched(fn, run):
    """``run()``'s output, checking that it launched ``fn``'s f32
    instantiation once and its bf16 one never."""
    before = (fn.launches, fn.f32_launches)
    out = run()
    torch.cuda.synchronize()
    assert (fn.launches, fn.f32_launches) == (before[0], before[1] + 1)
    return out


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("hkv,g,d,ps,w", [(8, 3, 128, 16, 65), (2, 2, 64, 8, 9),
                                          (1, 4, 256, 16, 70), (1, 8, 256, 16, 50),
                                          (2, 3, 192, 16, 20), (2, 2, 40, 4, 30)])
def test_paged_decode_f32_matches_plain(dev, kv_bits, window, hkv, g, d, ps, w):
    """An f32 query (a float32 model): f32 output, f32 16-bit pools; ragged
    rows over one split and several (the merge), an empty row, one at its
    table's end; llama3.2-3b's heads, gemma3-1b's and paligemma-3b's (D 256,
    two-warp blocks with f32 pools), D 192, and D 40 (a 16-dim step half past
    the row) at page size 4; within f32 summation-order error of the plain
    version, and two calls give the same bits."""
    rng = np.random.default_rng(kv_bits + d + (window or 0))
    b = 5
    lengths = [0, 1, 2 * ps + 3, w * ps // 2 + 5, w * ps]
    q, args = _paged_case(rng, dev, kv_bits, b, hkv, g, d, ps, w, lengths)
    n_layers = args[0].shape[0]
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, args[0].shape[1], ps, hkv, d,
                            torch.float32)
    nk, nks = _tokens(rng, dev, kv_bits, (b, hkv), d, torch.float32)
    nv, nvs = _tokens(rng, dev, kv_bits, (b, hkv), d, torch.float32)
    args = (kp, vp, ks, vs, *args[4:7], nk, nv, nks, nvs)
    q = q.float()
    got = _launched(paged_mqa_decode_cuda, lambda: ops.paged_mqa_decode(
        q, *args, kv_bits=kv_bits, window=window))
    assert got.dtype == torch.float32
    exp = ref.paged_mqa_decode_ref(q, *args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits,
                                   window=window)
    torch.testing.assert_close(got, exp, **F32_ATTN_TOL)
    assert torch.equal(got, ops.paged_mqa_decode(q, *args, kv_bits=kv_bits, window=window))


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 19])
@pytest.mark.parametrize("c", [1, 5, 128])
@pytest.mark.parametrize("hkv,g,d", [(2, 3, 64), (8, 3, 128), (1, 4, 256), (1, 4, 192),
                                     (2, 2, 40)])
def test_paged_prefill_f32_matches_plain(dev, kv_bits, window, c, hkv, g, d):
    """An f32 query: chunks of 1 and 128 and a verify window (C 5) with
    ragged q_lens and a padding row, D 64 / 128 / 256 (32-key tiles), 192
    (padded to 256) and 40 (padded to 64; int rows by 8- and 4-byte copies);
    within f32 summation-order error of the plain version, and two runs give
    the same bits."""
    rng = np.random.default_rng(kv_bits * 100 + c + d)
    b, n_layers, ps = 4, 2, 16
    ctx_list = [300, 97, 0, 40]
    w = -(-(max(ctx_list) + c) // ps)
    n_pages = b * w + 2
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d, torch.float32)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    q_lens = torch.tensor([c, max(c - 1, 1), (c + 1) // 2, 0], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32)).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d, torch.float32)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d, torch.float32)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
    got = _launched(paged_mqa_prefill_cuda, lambda: ops.paged_mqa_prefill(
        *args, kv_bits=kv_bits, window=window))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits,
                                    window=window)
    live = torch.arange(c, device=dev)[None, :] < q_lens[:, None]
    torch.testing.assert_close(got[live], exp[live], **F32_ATTN_TOL)
    assert torch.equal(got, ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window))


def test_paged_f32_geometry_matches_the_build(dev):
    """The wrappers' mirrors of the kernels' geometry (``paged_prefill``'s
    ``smem_bytes``, ``keys_per_tile`` and ``row_warps``,
    ``paged_decode.block_warps``) equal the library's, for both query types,
    every kv_bits, padded head dim and (f32 prefill) row warps."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pf

    lib = _build.lib()
    for itemsize in (2, 4):
        for kv_bits in (4, 8, 16):
            for dp in pf.HEAD_DIMS:
                for rw in ((1, 2, 4) if itemsize == 4 else (4,)):
                    assert lib.paged_prefill_smem_bytes(dp, kv_bits, itemsize, rw) == pf.smem_bytes(
                        dp, kv_bits, itemsize, rw)
                    if itemsize == 4:
                        assert lib.paged_prefill_f32_keys_per_tile(dp, kv_bits, rw) == \
                            pf.keys_per_tile(dp, 4, kv_bits, rw)
            for d in (8, 64, 128, 192, 256):
                assert lib.paged_decode_block_warps(d, kv_bits, itemsize) == pd.block_warps(
                    d, kv_bits, itemsize)
    for rows in range(1, 200):
        assert lib.paged_prefill_f32_row_warps(rows) == pf.row_warps(rows, 4)
    assert lib.paged_prefill_smem_bytes(128, 8, 2, 1) == -1


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("b,hkv,g,d,c,ctx_list,q_lens,window", [
    (8, 8, 3, 128, 5, [512, 1024, 700, 513, 1000, 640, 901, 0], [1, 2, 3, 4, 5, 5, 3, 0], None),
    (8, 1, 8, 256, 5, [768, 800, 790, 769, 777, 783, 795, 0], [1, 2, 3, 4, 5, 5, 3, 0], None),
    (4, 1, 4, 256, 128, [1536, 1480, 1300, 1536], [128, 127, 64, 1], 1024),
    (4, 8, 3, 128, 128, [256, 200, 384, 128], [128, 127, 64, 1], None),
    (3, 2, 4, 64, 6, [0, 5, 333], [6, 1, 4], 40),
    (2, 2, 1, 32, 9, [70, 0], [9, 9], None),
    (5, 1, 2, 192, 300, [0, 40, 1000, 7, 64], [300, 1, 150, 299, 0], 256)])
def test_paged_prefill_f32_plans_and_merges(dev, kv_bits, b, hkv, g, d, c, ctx_list, q_lens,
                                            window):
    """The f32 kernel under each kind of plan: row blocks of 16, 32 and 64
    query rows (the key warps of a 16-row block splitting every tile), key
    tiles split over blocks with a merge launch where the grid is under a
    wave (the serving verify windows) and none where it fills the card;
    32-key tiles at D 256; windows, ctx 0 and empty rows.  Within
    ``F32_ATTN_TOL`` of the plain version, the merge counted once where the
    plan splits, and two runs give the same bits."""
    from repro_torch.kernels import paged_prefill as pf

    rng = np.random.default_rng(kv_bits + d + c)
    n_layers, ps = 2, 16
    w = -(-(max(ctx_list) + c) // ps)
    n_pages = b * w + 2
    kp, vp, ks, vs = _pools(rng, dev, kv_bits, n_layers, n_pages, ps, hkv, d, torch.float32)
    tables = torch.from_numpy(
        rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)).to(dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d)).astype(np.float32)).to(dev)
    ck, cks = _tokens(rng, dev, kv_bits, (b, c, hkv), d, torch.float32)
    cv, cvs = _tokens(rng, dev, kv_bits, (b, c, hkv), d, torch.float32)
    args = (q, kp, vp, ks, vs, tables, ctx, ql, 1, ck, cv, cks, cvs)
    plan = pf.prefill_plan(b, hkv, c, g, d, w, ps, window, kv_bits, 4)
    merges = paged_mqa_prefill_cuda.f32_merge_launches
    got = _launched(paged_mqa_prefill_cuda, lambda: ops.paged_mqa_prefill(
        *args, kv_bits=kv_bits, window=window))
    assert paged_mqa_prefill_cuda.f32_merge_launches == merges + (plan["splits"] > 1)
    assert torch.isfinite(got).all()
    exp = ref.paged_mqa_prefill_ref(*args, sm_scale=1 / math.sqrt(d), kv_bits=kv_bits,
                                    window=window)
    live = torch.arange(c, device=dev)[None, :] < ql[:, None]
    torch.testing.assert_close(got[live], exp[live], **F32_ATTN_TOL)
    assert torch.equal(got, ops.paged_mqa_prefill(*args, kv_bits=kv_bits, window=window))


def test_paged_kernels_refuse_other_query_types_and_mixed_pools(dev):
    """An f16 query raises; an f32 query over a bf16 16-bit pool (or a
    bf16 query over an f32 one) raises: no cast hides a type."""
    rng = np.random.default_rng(3)
    q, args = _paged_case(rng, dev, 16, 2, 2, 3, 64, 16, 4, [20, 64])
    qg = q.reshape(2, 2, 3, 64)
    kw = dict(kv_bits=16, sm_scale=0.125)
    with pytest.raises(TypeError, match="bf16 or float32"):
        paged_mqa_decode_cuda(qg.half(), *args, **kw)
    with pytest.raises(TypeError, match="k_pool must be torch.float32"):
        paged_mqa_decode_cuda(qg.float(), *args, **kw)
    f32_args = tuple(t.float() if torch.is_tensor(t) and t.dtype == torch.bfloat16 else t
                     for t in args)
    with pytest.raises(TypeError, match="k_pool must be torch.bfloat16"):
        paged_mqa_decode_cuda(qg, *f32_args, **kw)
    qp = torch.zeros(2, 2, 5, 3, 64, dtype=torch.float16, device=dev)
    chunk = torch.zeros(2, 2, 5, 64, dtype=torch.float16, device=dev)
    kp, vp, _, _, tables, lens = args[:6]
    with pytest.raises(TypeError, match="bf16 or float32"):
        paged_mqa_prefill_cuda(qp, kp, vp, None, None, tables, lens, lens, 0, chunk, chunk,
                               None, None, **kw)


# ------------------------------------------------------------------ MoE
def _moe_case(bits, seed=0):
    """moe_ffn's parameters (D 512, F 1024, 8 experts; W4/W8 quantized per
    expert, or bf16) and 2 x 64 bf16 tokens, on the CPU."""
    from repro_torch.models import moe
    from repro_torch.models.layers import quantize_dense_weight

    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe_params(gen, 512, 1024, 8, torch.bfloat16)
    if bits < 16:
        params = {k: v if k == "router" else quantize_dense_weight(v, bits)
                  for k, v in params.items()}
    x = torch.randn(2, 64, 512, generator=gen).to(torch.bfloat16)
    return params, x


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_moe_ffn_on_card_matches_cpu(dev, bits):
    """moe_ffn on 128 tokens, top-2 of 8 (capacity 40): the card's routing
    (ids, slots, drops) equals the CPU's; its bf16 output, through the CF
    kernel once per expert and product for W4/W8, is within twice the CPU
    bf16 run's distance from the CPU float32 run (the rule of chip_smoke.py's
    phase 3), in the largest and the mean difference."""
    from repro_torch.models import moe

    params, x = _moe_case(bits)
    card_params = _to(params, dev)
    te, ce = (moe._route(t.reshape(-1, 512), p["router"], 2)[1] for t, p in
              ((x.to(dev), card_params), (x, params)))
    assert torch.equal(te.cpu(), ce)
    before = mpmm_cuda.launches
    card = moe.moe_ffn(x.to(dev), card_params, top_k=2)[0]
    torch.cuda.synchronize()
    assert mpmm_cuda.launches - before == (3 * 8 if bits < 16 else 0)
    cpu = moe.moe_ffn(x, params, top_k=2)[0]
    wide = {k: v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v
            for k, v in params.items()}
    f32 = moe.moe_ffn(x.float(), wide, top_k=2)[0]
    a, e = card.cpu().float(), cpu.float()
    assert torch.isfinite(a).all()
    diff, noise = (a - e).abs(), (f32 - e).abs()
    assert diff.max() <= 2 * noise.max() and diff.mean() <= 2 * noise.mean()


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_moe_ffn_captured_replays_eager_bits(dev, bits):
    """moe_ffn captured once as a step (serve/graphs.py) and replayed with
    new tokens equals the eager call bit for bit; the eager call runs under
    sync-debug "error", so it reads nothing back to the host."""
    from repro_torch.models import moe
    from repro_torch.serve import graphs

    params, _ = _moe_case(bits)
    params = _to(params, dev)
    g = graphs.StepGraphs(dev)
    gen = torch.Generator(device=dev).manual_seed(bits)

    def fn(x):
        return moe.moe_ffn(x, params, top_k=2)[0]

    for _ in range(3):
        x = torch.randn(2, 64, 512, generator=gen, device=dev).to(torch.bfloat16)
        got = g.run(("moe", bits), fn, (x,)).clone()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with graphs.disable_capture():
                want = fn(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got, want)
    assert g.captured == 1 and g.replays == 2


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
    """Head dims past 256 raise in the wrapper (q quarters live in
    registers; the wide instantiation is sized for 256)."""
    q = torch.zeros(1, 2, 1, 264, dtype=torch.bfloat16, device=dev)
    kd = torch.zeros(1, 8, 2, 264, dtype=torch.int8, device=dev)
    sc = torch.ones(1, 8, 2, 1, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dims up to 256"):
        mqa_decode_cuda(q, kd, kd, sc, sc, lens, kv_bits=8, sm_scale=1.0)


# head dims past 128 (the wide instantiation, 2 queries a block):
# paligemma-3b's 1 kv head x 8 queries at D 256 with a split row, one query
# per kv head, and D 160 / 192, whose last units are owned by some lanes only
@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("b,s,hkv,g,d,lengths", [
    (4, 2048, 1, 8, 256, [2048, 2047, 1000, 1]),
    (2, 300, 4, 1, 256, [300, 33]),
    (3, 77, 2, 3, 160, [77, 8, 0]),
    (2, 520, 2, 5, 192, [520, 64]),
])
def test_mqa_decode_kernel_head_dim_256(dev, kv_bits, b, s, hkv, g, d, lengths):
    from repro_torch.kernels.mqa_decode import GROUP_QUERIES_WIDE, decode_plan

    rng = np.random.default_rng(d + g + kv_bits)
    kd, vd, ks, vs = _contiguous_kv(rng, dev, kv_bits, b, s, hkv, d)
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = lens > 0
    plan = decode_plan(b, hkv, g, s, d)
    assert plan["groups"] == -(-g // GROUP_QUERIES_WIDE)
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        qd = q.to(dtype)
        before = mqa_decode_cuda.launches
        got = ops.mqa_decode(qd, kd, vd, ks, vs, lens, kv_bits=kv_bits)
        torch.cuda.synchronize()
        assert mqa_decode_cuda.launches == before + 1
        exp = ops.mqa_decode(qd.cpu(), kd.cpu(), vd.cpu(), ks.cpu(), vs.cpu(), lens.cpu(),
                             kv_bits=kv_bits)
        assert got.dtype == dtype and got.shape == (b, hkv * g, d)
        torch.testing.assert_close(got[live].float().cpu(), exp[live.cpu()].float(), **tol)
        assert (got[~live] == 0).all()
        assert torch.equal(got, ops.mqa_decode(qd, kd, vd, ks, vs, lens, kv_bits=kv_bits))


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
    """A copy of a param tree on ``device`` (ints, such as a quantized
    weight's bits, kept as they are)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True) if isinstance(tree, torch.Tensor) else tree


# ------------------------------------------------------- captured steps
# serve/graphs.py: each step captured, then replayed with new inputs, must
# give the eager step's bits, and leave the pools (or the wave's cache) as
# the eager step leaves them.  The eager reference runs under
# torch.cuda.set_sync_debug_mode("error"): a step that reads the card back
# to the host raises there, and could not be captured.
def _llama(dev, kv_bits=8):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="bfloat16",
                              serve_kv_bits=kv_bits)
    base = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    return cfg, {w: T.quantize_params(base, w) for w in (4, 8)}


def _pool_pair(dev, cfg, n_pages=24, ps=16):
    """Two equal random page pools (k, v, k_scale, v_scale) on the card."""
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads,
             cfg.hd // 2 if cfg.serve_kv_bits == 4 else cfg.hd)
    if cfg.serve_kv_bits < 16:
        pools = [torch.randint(-100, 100, shape, generator=g, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        pools += [torch.rand((*shape[:-1], 1), generator=g, device=dev) * 0.05
                  for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(2)] + [None, None]
    return pools, [None if p is None else p.clone() for p in pools]


def _same_bits(a, b) -> bool:
    if a is None:
        return b is None
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _samp(dev, b, sampled):
    """(host float64 [5, B] on the card, kind) as the engine packs them."""
    if not sampled:
        return None, None
    host = np.zeros((5, b))
    host[0], host[1], host[2], host[3], host[4] = 0.8, 20, 0.9, np.arange(b), 3
    return torch.from_numpy(host).to(dev), (True, True)


def _run_both(dev, step, cfg, static, arrays_by_call, samp, body):
    """Call ``body`` through a StepGraphs (captured; pools A) and eagerly
    under sync-debug "error" (pools B) for each call's arrays; every output
    must be bit-equal.  Returns the StepGraphs."""
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import _samp_views

    g = graphs.StepGraphs(dev)
    samp_dev, kind = samp
    for arrays in arrays_by_call:
        flat, shapes = graphs.pack(arrays)
        inputs = (torch.from_numpy(flat).to(dev), samp_dev)
        key = graphs.step_key(step, cfg, (*static, shapes, kind), inputs)

        def fn(which):
            return lambda ints, s: body(which, *graphs.unpack(ints, shapes), _samp_views(s, kind))

        got = g.run(key, fn(0), inputs).clone()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with graphs.disable_capture():
                want = fn(1)(*inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got, want), step
    assert g.captured == 1 and g.replays == len(arrays_by_call) - 1
    return g


def _decode_calls(rng, b, w, n_pages=24):
    """Four decode calls at fixed (B, W): new tokens and lengths each time;
    the last row is bucket padding."""
    tables = rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    tables[-1] = 0
    out = []
    for i in range(4):
        lengths = rng.integers(0, w * 16 - 8, b).astype(np.int32) + i
        lengths[-1] = 0
        valid = np.arange(b) < b - 1
        out.append([tables, rng.integers(0, 512, (b, 1)), lengths, valid])
    return out


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_captured_decode_step_replays_eager_bits(dev, kv_bits, sampled):
    from repro_torch.serve.decode import paged_decode_sample

    cfg, params = _llama(dev, kv_bits)
    pools = _pool_pair(dev, cfg)
    calls = _decode_calls(np.random.default_rng(kv_bits), 4, 4)

    def body(which, tables, tokens, lengths, valid, samp):
        return paged_decode_sample(params[8], tokens, lengths, tables, valid != 0, samp,
                                   *pools[which], cfg=cfg)[0]

    _run_both(dev, "decode", cfg, (8,), calls, _samp(dev, 4, sampled), body)
    assert all(_same_bits(a, b) for a, b in zip(*pools))


@pytest.mark.parametrize("sampled", [False, True])
def test_captured_spec_round_replays_eager_bits(dev, sampled):
    from repro_torch.serve.spec_decode import spec_decode_round

    cfg, params = _llama(dev, 8)
    pools = _pool_pair(dev, cfg)
    rng = np.random.default_rng(5)
    calls = [[*c, np.array([3, 1, 0, 0], np.int32)] for c in _decode_calls(rng, 4, 4)]

    def body(which, tables, tokens, lengths, valid, nd, samp):
        emit, accept, _ = spec_decode_round(params[4], params[8], tokens, lengths, tables,
                                            valid != 0, nd, samp, *pools[which], cfg=cfg,
                                            spec_k=3)
        return torch.cat([emit, accept[:, None].to(emit.dtype)], dim=1)

    _run_both(dev, "spec", cfg, (8, 4, 3), calls, _samp(dev, 4, sampled), body)
    assert all(_same_bits(a, b) for a, b in zip(*pools))


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_captured_chunk_call_replays_eager_bits(dev, kv_bits):
    from repro_torch.serve.prefill import chunk_prefill_sample

    cfg, params = _llama(dev, kv_bits)
    pools = _pool_pair(dev, cfg)
    rng = np.random.default_rng(9)
    tables = rng.permutation(24)[:8].reshape(2, 4).astype(np.int32)
    calls = [[tables, rng.integers(0, 512, (2, 16)), np.array([16 * i, 8 * i], np.int32),
              np.array([16, 9 - i], np.int32)] for i in range(4)]

    def body(which, tables, tokens, q_start, q_lens, samp):
        return chunk_prefill_sample(params[8], tokens, q_start, q_lens, tables, samp,
                                    *pools[which], cfg=cfg)[0]

    _run_both(dev, "chunk", cfg, (8,), calls, (None, None), body)
    assert all(_same_bits(a, b) for a, b in zip(*pools))


def test_captured_wave_step_replays_eager_bits(dev):
    """Reduced zamba2-7b (w8/kv8, bf16) waves: a captured Server and an
    eager one, the same weights, four decode steps each after one prefill:
    the same tokens and the same caches, bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import graphs
    from repro_torch.train.server import Server

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), n_layers=5)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    srvs = [Server(cfg, params, batch_size=2, max_len=24, device=dev) for _ in range(2)]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))).to(dev)
    (tok_c, cache_c), (tok_e, cache_e) = [s.prefill_wave({"tokens": tokens}) for s in srvs]
    for _ in range(4):
        tok_c = srvs[0].decode_wave(tok_c).clone()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with graphs.disable_capture():
                tok_e = srvs[1].decode_wave(tok_e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(tok_c, tok_e)
    assert srvs[0].graphs.captured == 1 and srvs[0].graphs.replays == 3
    assert all(_same_bits(cache_c[k], cache_e[k]) for k in cache_c)
    assert int(cache_c["pos"]) == 9 + 4


def test_replays_add_the_captured_launch_counts(dev):
    """The warm-up call counts its launches as they run; the capture adds
    none (it ran nothing); every replay adds the capture's counts."""
    from repro_torch.serve.decode import paged_decode_sample

    cfg, params = _llama(dev, 8)
    pools = _pool_pair(dev, cfg)
    calls = _decode_calls(np.random.default_rng(3), 4, 4)

    def body(which, tables, tokens, lengths, valid, samp):
        return paged_decode_sample(params[8], tokens, lengths, tables, valid != 0, samp,
                                   *pools[which], cfg=cfg)[0]

    before = (mpmm_cuda.launches, paged_mqa_decode_cuda.launches)
    _run_both(dev, "decode", cfg, (8,), calls[:1], (None, None), body)
    one = (mpmm_cuda.launches - before[0], paged_mqa_decode_cuda.launches - before[1])
    per_call = (one[0] // 2, one[1] // 2)  # the captured warm-up and the eager reference
    assert per_call[1] == cfg.n_layers and per_call[0] > cfg.n_layers
    before = (mpmm_cuda.launches, paged_mqa_decode_cuda.launches)
    _run_both(dev, "decode", cfg, (8,), calls, (None, None), body)  # 1 warm-up, 3 replays
    assert (mpmm_cuda.launches - before[0], paged_mqa_decode_cuda.launches - before[1]) == \
        (8 * per_call[0], 8 * per_call[1])


def test_a_step_that_syncs_inside_capture_raises(dev):
    """A host read inside a step passes the eager warm-up but cannot be
    captured: the call raises, keeps no graph, and returns nothing eager."""
    from repro_torch.serve import graphs

    g = graphs.StepGraphs(dev)
    x = torch.arange(8, dtype=torch.float32, device=dev)

    def syncs(x):
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError):
        g.run(("syncs",), syncs, (x,))
    assert g.captured == 0
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.arange(0, 16, 2, dtype=torch.float32, device=dev))


# ------------------------------------------- the one-shot prefix prefill
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_write_prompt_keeps_the_card_pools(dev, kv_bits):
    """``PagedKVCache.write_prompt`` on card pools: every pool keeps its
    storage, and the pages hold what the CPU pool's write gives."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.kv_cache import PagedKVCache

    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(), serve_kv_bits=kv_bits)
    caches = [PagedKVCache(cfg, num_pages=12, page_size=4, kv_bits=kv_bits, device=d)
              for d in (dev, "cpu")]
    rng = np.random.default_rng(kv_bits)
    dk = cfg.hd // 2 if kv_bits == 4 else cfg.hd
    shape = (cfg.n_layers, 12, cfg.n_kv_heads, dk)
    if kv_bits < 16:
        rows = [torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
                for _ in range(2)]
        rows += [torch.from_numpy(rng.random((*shape[:-1], 1)).astype(np.float32))
                 for _ in range(2)]
    else:
        rows = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
                for _ in range(2)]
    ptrs = [p.data_ptr() for p in caches[0].pools if p is not None]
    for c in caches:
        c.allocate(0, 2)
        c.allocate(1, 3)
        c.write_prompt(1, *[r.to(c.device) for r in rows])
    torch.cuda.synchronize()
    assert [p.data_ptr() for p in caches[0].pools if p is not None] == ptrs
    for a, b in zip(*(c.pools for c in caches)):
        assert _same_bits(None if a is None else a.cpu(), b)


def test_captured_decode_reads_a_later_one_shot_prefill(dev):
    """Reduced paligemma-3b (bf16, w8 / kv8) on the card: request 1 is
    prefilled and decoded (its decode step captured); request 2, admitted
    after it, is prefilled in one shot into pages the captured step then
    reads on replay.  Its stream equals an eager engine's, where every pool
    is read afresh, and no pool moved."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    cfg = get_config("paligemma-3b").reduced()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    p1, p2 = (rng.integers(0, cfg.vocab, 20).astype(np.int32) for _ in range(2))
    prec = PrecisionParams(w_bits=8, kv_bits=8)

    def submit(eng, prompt):
        return eng.submit(prompt, SamplingParams(max_new_tokens=6), prec)

    eng = ServeEngine(cfg, params, max_slots=1, page_size=8, num_pages=8, device=dev)
    submit(eng, p1)
    eng.run()
    ptrs = [p.data_ptr() for p in eng.cache_for(8).pools]
    captured, replays = eng.graphs.captured, eng.graphs.replays
    assert captured >= 1 and replays >= 1
    r2 = submit(eng, p2)
    eng.run()
    assert eng.graphs.captured == captured and eng.graphs.replays == replays + 5
    assert [p.data_ptr() for p in eng.cache_for(8).pools] == ptrs
    eager = ServeEngine(cfg, params, max_slots=1, page_size=8, num_pages=8, device=dev)
    with graphs.disable_capture():
        e2 = submit(eager, p2)
        eager.run()
    assert r2.out_tokens == e2.out_tokens and len(r2.out_tokens) == 6


# ------------------------------------------------------------ training path
def _train_step_on(device, cfg, params16, batch, optimizer):
    """One make_train_step step on ``device``: (loss, grad norm, grads
    before the clip, params after the step), all on the CPU."""
    import dataclasses

    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import value_and_grad

    params = _to(params16, device)
    b = {k: v.to(device) for k, v in batch.items()}
    _, _, grads = value_and_grad(params, b, cfg)
    step_fn, opt_init = make_train_step(dataclasses.replace(cfg, optimizer=optimizer),
                                        TrainConfig(lr=3e-3, warmup=0, total_steps=10))
    params, _, m = step_fn(params, opt_init(params), b, 0)
    return (float(m["loss"]), float(m["grad_norm"]), [g.cpu() for g in grads],
            [p.cpu() for p in tree.leaves(params)])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_on_card_matches_cpu(dev, optimizer):
    """Reduced llama3.2-3b in float32 (TF32 off): the loss, the grad norm and
    every gradient leaf within ``rtol = atol = 1e-4`` card vs CPU, the
    updated params within ``1e-5`` (under adamw, elements whose gradient is
    below 1e-6, where the step is g / (|g| + eps), within 2 lr)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(DataConfig(cfg.vocab, 64, 4, seed=1), 0, cfg, device="cpu")
    card = _train_step_on(dev, cfg, params, batch, optimizer)
    cpu = _train_step_on("cpu", cfg, params, batch, optimizer)
    np.testing.assert_allclose(card[:2], cpu[:2], rtol=1e-4, atol=1e-4)
    for a, e in zip(card[2], cpu[2]):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-4, atol=1e-4)
    for a, e, g in zip(card[3], cpu[3], cpu[2]):
        tiny = (g.abs() < 1e-6) if optimizer == "adamw" else torch.zeros_like(g, dtype=bool)
        np.testing.assert_allclose(a[~tiny].numpy(), e[~tiny].numpy(), rtol=1e-5, atol=1e-5)
        assert np.abs((a[tiny] - e[tiny]).numpy()).max(initial=0) <= 2 * 3e-3


def test_trainer_resume_on_card_is_bit_equal(dev, tmp_path):
    """Reduced llama3.2-3b (bf16) through Trainer on the card: a run that
    fails at step 7 and resumes from its step-5 checkpoint ends with the
    uninterrupted run's params, state and losses, bit for bit (the trainer
    runs its steps with deterministic kernels)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import run_with_restarts
    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("llama3.2-3b").reduced()

    def trainer(name):
        tc = TrainConfig(lr=3e-3, warmup=2, total_steps=10, ckpt_every=5,
                         ckpt_dir=str(tmp_path / name))
        return Trainer(cfg, tc, DataConfig(cfg.vocab, 64, 4), device=dev)

    ref = trainer("ref").run(10)
    crash = trainer("crash")
    out = run_with_restarts(lambda s: crash.run(10, start_step=s,
                                                fail_at=7 if s != -1 else None))
    assert [h["step"] for h in out["history"]] == list(range(7)) + list(range(5, 10))
    for a, b in zip(tree.leaves((ref["params"], ref["opt_state"])),
                    tree.leaves((out["params"], out["opt_state"]))):
        assert a.device.type == "cuda" and torch.equal(a, b)
    losses = {h["step"]: h["loss"] for h in ref["history"]}
    assert all(h["loss"] == losses[h["step"]] for h in out["history"])
    assert not torch.are_deterministic_algorithms_enabled()  # scoped to the run


def _trainer(dev, name, root, steps=4, ckpt_every=0, **over):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    tc = TrainConfig(lr=3e-3, warmup=2, total_steps=steps, ckpt_every=ckpt_every,
                     ckpt_dir=str(root))
    return Trainer(cfg, tc, DataConfig(cfg.vocab, 64, 4), device=dev)


@pytest.mark.parametrize("name,over", [
    ("llama3.2-3b", {}), ("llama3.2-3b", dict(optimizer="adamw8bit", remat="full")),
    ("mamba2-130m", dict(remat="full")), ("mixtral-8x22b", dict(optimizer="adafactor")),
])
def test_captured_trainer_replays_eager_bits(dev, tmp_path, name, over):
    """A reduced arch through Trainer on the card, 4 steps captured (step 0
    eager, then one capture and 3 replays) and 4 steps under
    ``disable_capture()``: the same losses, grad norms, params and optimizer
    state, bit for bit, under the trainer's deterministic kernels."""
    from repro_torch.optim import tree
    from repro_torch.serve import graphs

    cap = _trainer(dev, name, tmp_path / "c", **over)
    out_c = cap.run(4)
    assert cap.graphs.captured == 1 and cap.graphs.replays == 3
    eager = _trainer(dev, name, tmp_path / "e", **over)
    with graphs.disable_capture():
        out_e = eager.run(4)
    assert eager.graphs.captured == 0
    for key in ("loss", "grad_norm"):
        assert [h[key] for h in out_c["history"]] == [h[key] for h in out_e["history"]]
    for a, b in zip(tree.leaves((out_c["params"], out_c["opt_state"])),
                    tree.leaves((out_e["params"], out_e["opt_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out_c["opt_state"].step) == 4
    assert not torch.are_deterministic_algorithms_enabled()


def test_restore_into_a_captured_trainer(dev, tmp_path):
    """A captured Trainer that fails at step 5 and resumes from its step-3
    checkpoint writes the restored state into the tensors its graph was
    captured over (no second capture, the same storage) and ends bit-equal
    to an uninterrupted eager run."""
    from repro_torch.distributed import run_with_restarts
    from repro_torch.optim import tree
    from repro_torch.serve import graphs

    crash = _trainer(dev, "llama3.2-3b", tmp_path / "crash", steps=8, ckpt_every=3)
    seen = []  # the Trainer's state tensors as each attempt starts

    def attempt(start):
        seen.append(None if crash._state is None else
                    [t.data_ptr() for t in tree.leaves(crash._state)])
        return crash.run(8, start_step=start, fail_at=5 if start != -1 else None)

    out = run_with_restarts(attempt)
    ptrs = [t.data_ptr() for t in tree.leaves((out["params"], out["opt_state"]))]
    assert seen[0] is None and seen[1] == ptrs
    assert [h["step"] for h in out["history"]] == list(range(5)) + list(range(3, 8))
    assert crash.graphs.captured == 1 and crash.graphs.replays == 4 + 5
    ref = _trainer(dev, "llama3.2-3b", tmp_path / "ref", steps=8)
    with graphs.disable_capture():
        out_ref = ref.run(8)
    for a, b in zip(tree.leaves((out_ref["params"], out_ref["opt_state"])),
                    tree.leaves((out["params"], out["opt_state"]))):
        assert torch.equal(a, b)
    losses = {h["step"]: h["loss"] for h in out_ref["history"]}
    assert all(h["loss"] == losses[h["step"]] for h in out["history"])


def test_lr_on_the_card_equals_the_cpu_schedule(dev):
    """The cosine schedule fed a step tensor on the card (the captured
    step's) gives the CPU schedule's bits at every step, across the warm-up
    boundary and past the end."""
    from repro_torch.optim.schedules import cosine_schedule

    for base, warm, total in ((3e-4, 100, 1000), (6e-4, 30, 300), (3e-3, 5, 30),
                              (0.1, 0, 10)):
        lr = cosine_schedule(base, warm, total)
        steps = torch.arange(total + 3, dtype=torch.int32, device=dev)
        got = torch.stack([lr(s) for s in steps]).cpu()
        exp = torch.stack([lr(int(s)) for s in range(total + 3)])
        assert got.dtype == torch.float32 and torch.equal(got, exp)


def test_full_width_mamba_train_step_is_finite(dev):
    """Full mamba2-130m (24 layers, d_model 768, remat "full"), one step of
    make_train_step at batch 2 x 512: finite loss, grad norm and params."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config("mamba2-130m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    step_fn, opt_init = make_train_step(cfg, TrainConfig(warmup=0, total_steps=10))
    batch = make_batch(DataConfig(cfg.vocab, 512, 2), 0, cfg, device=dev)
    params, _, m = step_fn(params, opt_init(params), batch, 0)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(params))


# ---- the multi-device modules over NCCL at world size 1 (one card; NCCL
# refuses two ranks on one GPU): compressed_grad_reduce card vs CPU (gloo),
# the all-to-all MoE dispatch against the replicated one, a one-stage
# pipeline_apply
@pytest.fixture
def nccl_mesh(dev):
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_test_mesh

    joined = init_distributed("cuda", timeout=datetime.timedelta(minutes=2))
    try:
        yield make_test_mesh(1, 1, device="cuda")
    finally:
        if joined:
            dist.destroy_process_group()


def test_compressed_grad_reduce_over_nccl_matches_cpu(nccl_mesh):
    import torch.distributed as dist

    from repro_torch.distributed import collectives as col

    class CpuAxis:
        group = dist.new_group([0], backend="gloo")

        def get_group(self, axis):
            return self.group

    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = {"embed": torch.randn(4096, 3072, generator=gen, device="cuda") * 1e-3,
             "norm": torch.randn(3072, generator=gen, device="cuda"),
             "tiny": torch.randn(7, 9, generator=gen, device="cuda")}
    red, new = col.compressed_grad_reduce(grads, col.init_error_state(grads), nccl_mesh)
    cpu = {k: g.cpu() for k, g in grads.items()}
    cred, cnew = col.compressed_grad_reduce(cpu, col.init_error_state(cpu), CpuAxis())
    for k, g in grads.items():
        q, s = col._quantize_chunks(g.reshape(-1), 1)
        cq, cs = col._quantize_chunks(cpu[k].reshape(-1), 1)
        assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs), k
        scale = float(cred[k].abs().max())
        for a, b in ((red[k], cred[k]), (new[k]["e1"], cnew[k]["e1"]),
                     (new[k]["e2"], cnew[k]["e2"])):
            assert float((a.cpu() - b).abs().max()) <= 1e-6 * scale, k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_alltoall_over_nccl_equals_replicated(nccl_mesh, dtype):
    from repro_torch.models import moe

    params = moe.init_moe_params(torch.Generator(device="cuda").manual_seed(0), 1024, 2048, 8,
                                 dtype)
    x = torch.randn(4, 64, 1024, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(dtype)
    for cf in (1.25, 0.5):
        a = moe.moe_ffn(x, params, top_k=2, capacity_factor=cf)
        b = moe.moe_ffn(x, params, top_k=2, capacity_factor=cf, dispatch="alltoall",
                        mesh=nccl_mesh)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), cf


def test_one_stage_pipeline_over_nccl(nccl_mesh):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1,), ("pod",), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn(1, 3072, 3072, generator=gen, device="cuda") / 3072 ** 0.5
    x = torch.randn(4, 8, 3072, generator=gen, device="cuda")
    got = pipeline_apply(lambda p, mb: torch.tanh(mb @ p), w, x, mesh, axis="pod")
    assert torch.equal(got, torch.stack([torch.tanh(mb @ w[0]) for mb in x]))


# ---- the tensor-parallel mapping (set_mesh(mesh)) over NCCL at world size 1:
# every collective spans one rank, so each path equals the unsharded one
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tp_moe_ffn_over_nccl_equals_unsharded(nccl_mesh, dtype):
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    params = moe.init_moe_params(torch.Generator(device="cuda").manual_seed(0), 1024, 2048, 8,
                                 dtype)
    x = torch.randn(4, 64, 1024, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(dtype)
    for cf in (1.25, 0.5):
        a = moe.moe_ffn(x, params, top_k=2, capacity_factor=cf)
        with sh.use_mesh(nccl_mesh):
            b = moe.moe_ffn(x, params, top_k=2, capacity_factor=cf)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), cf


def test_tp_server_waves_over_nccl_equal_unsharded(nccl_mesh):
    """Reduced kimi-k2 (w4, kv8: the CF matmul and mqa_decode) through
    Server(mesh=) on the 1 x 1 mesh, captured: the no-mesh Server's streams."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.mqa_decode import mqa_decode_cuda
    from repro_torch.models import transformer as model_lib
    from repro_torch.train.server import Request, Server

    cfg = get_config("kimi-k2-1t-a32b").reduced()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 4, 7)]

    def streams(mesh):
        params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        srv = Server(cfg, params, batch_size=2, max_len=24, device="cuda", mesh=mesh)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        srv.serve(reqs)
        return [list(r.out_tokens) for r in reqs]

    before = mqa_decode_cuda.launches
    assert streams(nccl_mesh) == streams(None)
    assert mqa_decode_cuda.launches > before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["llama3.2-3b", "mixtral-8x22b", "paligemma-3b",
                                  "musicgen-medium"])
def test_tp_engine_over_nccl_equals_unsharded(nccl_mesh, name, dtype):
    """Reduced llama3.2-3b / mixtral-8x22b / paligemma-3b / musicgen-medium
    (bf16, and float32: the f32 paged instantiations) through
    ServeEngine(mesh=) on the 1 x 1 mesh, mixed (w, kv) with
    spec on two requests, a prefix hit where the engine keeps a prefix cache
    (the one-shot-prefill families keep none, and their prefill runs under
    the mapping too): the unmeshed engine's streams and pools bit for bit,
    captured and eager, every captured key naming the split, the paged
    kernels launched."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import paged_mqa_decode_cuda
    from repro_torch.kernels.paged_prefill import paged_mqa_prefill_cuda
    from repro_torch.models import transformer as model_lib
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    attr = "f32_launches" if dtype == "float32" else "launches"
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (23, 21, 25, 22, 24)]
    prompts[4][:16] = prompts[0][:16]
    precs = [(4, 8, 0), (8, 4, 2), (16, 16, 0), (8, 4, 2), (4, 8, 0)]

    def run(mesh):
        params = model_lib.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        eng = ServeEngine(cfg, params, max_slots=4, num_pages=32, page_size=8, device="cuda",
                          mesh=mesh)
        out = []
        for wave in (range(4), range(4, 5)):
            hs = [eng.submit(prompts[i], SamplingParams(max_new_tokens=6),
                             PrecisionParams(w_bits=precs[i][0], kv_bits=precs[i][1],
                                             spec_k=precs[i][2])) for i in wave]
            eng.run()
            out += [list(h.out_tokens) for h in hs]
        assert eng.stats.prefix_hit_tokens == (0 if cfg.prefix_len else 16)
        assert eng.stats.spec_rounds > 0
        pools = {kv: [t.clone() for t in c.pools if t is not None]
                 for kv, c in eng._caches.items()}
        return out, pools, {key[2][-1] for key in eng.graphs.calls}, eng.split

    before = (getattr(paged_mqa_decode_cuda, attr), getattr(paged_mqa_prefill_cuda, attr))
    streams, pools, splits, split = run(nccl_mesh)
    assert splits == {split} and split[0] == "tp"
    assert getattr(paged_mqa_decode_cuda, attr) > before[0]
    assert getattr(paged_mqa_prefill_cuda, attr) > before[1]
    plain, plain_pools, plain_splits, _ = run(None)
    assert plain_splits == {None}
    assert streams == plain
    for kv in plain_pools:
        assert all(torch.equal(a, b) for a, b in zip(pools[kv], plain_pools[kv])), kv
    with graphs.disable_capture():
        assert run(nccl_mesh)[0] == streams
