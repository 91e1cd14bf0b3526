"""The port's CNN path against the JAX package on the CPU: the cycle model
(dataflow decisions and modelled numbers, exactly), the ISA encodings, the
FF-order and int-mode matmul, the multi-precision conv and the network
runner.  Inputs are numpy arrays made from a seed and handed to both
packages; the JAX side runs its Pallas kernels in interpret mode, as its own
tests do on the CPU.

Tolerances: integer paths are bit-exact.  float32 matmuls and convs use the
reference's mpmm tolerance, 2e-3; bf16 outputs one bf16 rounding step,
1e-2; the network runner's float32 outputs agree within 1e-4 of the output's
largest value (20 layers of float32 sums in another order).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import isa as jisa  # noqa: E402
from repro.core import perfmodel as jperf  # noqa: E402
from repro.core.dataflow import ConvLayer as JConvLayer  # noqa: E402
from repro.core.precision import Precision as JPrecision  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.cnn_zoo import BENCHMARK_NETWORKS as JNETS  # noqa: E402
from repro.quant.pack import pack_int4 as jpack_int4  # noqa: E402
from repro_torch.core import isa, perfmodel  # noqa: E402
from repro_torch.core.dataflow import ConvLayer  # noqa: E402
from repro_torch.core.precision import Precision  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import cnn as tcnn_cli  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.cnn_zoo import BENCHMARK_NETWORKS  # noqa: E402
from repro_torch.models.convert import cnn_params_from_numpy  # noqa: E402

RNG = np.random.default_rng(0)
F32_TOL = dict(atol=2e-3, rtol=2e-3)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _perf_fields(p):
    return (p.layer.name, None if p.dataflow is None else p.dataflow.name, p.cycles,
            p.gops, p.area_eff, p.energy_eff, p.utilization)


# ------------------------------------------------------------ cycle model
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("net", list(JNETS))
def test_cycle_model_matches_jax(net, bits):
    layers, jlayers = BENCHMARK_NETWORKS[net](), JNETS[net]()
    assert [dataclasses.astuple(l) for l in layers] == [dataclasses.astuple(l) for l in jlayers]
    prec, jprec = Precision(bits), JPrecision(bits)
    got = [perfmodel.select_dataflow(l, prec).name for l in layers]
    assert got == [jperf.select_dataflow(l, jprec).name for l in jlayers]
    for strategy in ("ff", "cf", "mixed"):
        a = perfmodel.evaluate_network(layers, prec, strategy)
        b = jperf.evaluate_network(jlayers, jprec, strategy)
        for key in ("gops", "area_eff", "energy_eff", "peak_layer_gops", "total_cycles"):
            assert a[key] == b[key], (strategy, key)
        assert [_perf_fields(p) for p in a["layers"]] == [_perf_fields(p) for p in b["layers"]]
    if bits == 4:
        with pytest.raises(ValueError):
            perfmodel.evaluate_network_ara(layers, prec)
        with pytest.raises(ValueError):
            jperf.evaluate_network_ara(jlayers, jprec)
    else:
        a = perfmodel.evaluate_network_ara(layers, prec)
        b = jperf.evaluate_network_ara(jlayers, jprec)
        assert (a["gops"], a["total_cycles"]) == (b["gops"], b["total_cycles"])


def test_resnet18_w8_picks_17_ff_and_3_cf():
    got = [perfmodel.select_dataflow(l, Precision.INT8).name
           for l in BENCHMARK_NETWORKS["ResNet18"]()]
    assert got.count("FF") == 17 and got.count("CF") == 3
    cf = [l.name for l in BENCHMARK_NETWORKS["ResNet18"]()
          if perfmodel.select_dataflow(l, Precision.INT8).name == "CF"]
    assert all(name.endswith(".down") for name in cf)


def test_precision_specs_match_jax():
    from repro.core import precision as jp
    from repro_torch.core import precision as tp

    assert tp.UNIFIED_ELEMENT_BITS == jp.UNIFIED_ELEMENT_BITS
    assert tp.PE_MULTIPLIERS_4B == jp.PE_MULTIPLIERS_4B
    for bits in (4, 8, 16):
        a, b = tp.Precision(bits), jp.Precision(bits)
        assert dataclasses.astuple(a.spec) == dataclasses.astuple(b.spec)
        assert (a.spec.qmin, a.spec.qmax, a.spec.ops_per_mac_cycle) == (
            b.spec.qmin, b.spec.qmax, b.spec.ops_per_mac_cycle)
        assert tp.throughput_scale(a) == jp.throughput_scale(b)


# -------------------------------------------------------------------- ISA
def _instructions(mod):
    out = []
    for prec in (4, 8, 16):
        for df in (0, 1):
            out.append(mod.VSACFG(precision=mod.Precision(prec), dataflow=mod.Dataflow(df),
                                  kernel_hint=prec % 8, acc_clear=bool(df), tile_h=prec + 3,
                                  rd=df * 7))
    out += [mod.VSALD(vd=v, rs1=(v * 3) % 32, length=v % 32, broadcast=bool(v % 2))
            for v in (0, 5, 31)]
    out += [mod.VSAM(acc=a, vs1=(a + 1) % 32, vs2=(a + 9) % 32) for a in (0, 12, 31)]
    return out


def test_isa_encodings_match_jax():
    ours, theirs = _instructions(isa), _instructions(jisa)
    for a, b in zip(ours, theirs):
        word = isa.encode(a)
        assert word == jisa.encode(b)
        assert isa.disassemble(word) == jisa.disassemble(word)
        back = isa.decode(word)
        assert back == a and dataclasses.astuple(back) == dataclasses.astuple(jisa.decode(word))
    for bad in (0, 0xFFFFFFFF, 1 << 32):
        with pytest.raises(ValueError):
            isa.decode(bad)
        with pytest.raises(ValueError):
            jisa.decode(bad)


# ----------------------------------------------------------- mpmm, FF order
MPMM_SHAPES = [(8, 128, 128), (96, 384, 160), (1, 256, 512), (130, 520, 130)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", MPMM_SHAPES)
def test_mpmm_ff_matches_jax(m, k, n, w_bits, dtype):
    x = RNG.normal(size=(m, k)).astype(np.float32)
    w = RNG.normal(size=(k, n)).astype(np.float32)
    jd, js = jops.pack_weights(jnp.asarray(w), w_bits)
    xj = jnp.asarray(x, dtype)
    exp = _np(jops.mpmm(xj, jd, js, w_bits=w_bits, dataflow="ff", interpret=True))
    xt = _t(x).to(getattr(torch, dtype))
    got = ops.mpmm(xt, _t(jd), _t(js), w_bits=w_bits, dataflow="ff")
    assert got.dtype == xt.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), exp, **tol)
    # the FF plain version: 512-row stages in order, unscaled f32
    acc = ref.mpmm_ff_ref(xt, _t(jd), w_bits=w_bits)
    assert acc.dtype == torch.float32
    np.testing.assert_array_equal(
        got.float().numpy(), (acc * _t(js)).to(xt.dtype).float().numpy())


@pytest.mark.parametrize("w_bits", [4, 8])
def test_mpmm_ff_large_k_f32_partials_matches_jax(w_bits):
    """The reference's regression case: K = 4096 is eight FF stages whose
    partial sums must spill in f32; bf16 outputs within one rounding step of
    the JAX FF kernel and of the f32 oracle."""
    m, k, n = 8, 4096, 128
    x = RNG.normal(size=(m, k)).astype(np.float32)
    w = RNG.normal(size=(k, n)).astype(np.float32)
    jd, js = jops.pack_weights(jnp.asarray(w), w_bits)
    xj = jnp.asarray(x, jnp.bfloat16)
    jff = _np(jops.mpmm(xj, jd, js, w_bits=w_bits, dataflow="ff", interpret=True))
    xt = _t(_np(xj)).to(torch.bfloat16)
    ff = ops.mpmm(xt, _t(jd), _t(js), w_bits=w_bits, dataflow="ff")
    cf = ops.mpmm(xt, _t(jd), _t(js), w_bits=w_bits, dataflow="cf")
    assert ff.dtype == cf.dtype == torch.bfloat16
    np.testing.assert_allclose(ff.float().numpy(), jff, **BF16_TOL)
    np.testing.assert_allclose(ff.float().numpy(), cf.float().numpy(), **BF16_TOL)
    exp = _np(jref.mpmm_ref(xj, jd, js, w_bits=w_bits, mode="dequant"))
    np.testing.assert_allclose(ff.float().numpy(), exp, **BF16_TOL)


def test_mpmm_auto_dataflow_matches_jax_selector():
    for m, n, k in ((64, 128, 256), (1, 512, 4096), (4096, 64, 64), (7, 3, 1000)):
        got = ops.select_matmul_dataflow(m, n, k)
        assert got.name == jops.select_matmul_dataflow(m, n, k).name
    x = RNG.normal(size=(64, 256)).astype(np.float32)
    jd, js = jops.pack_weights(jnp.asarray(RNG.normal(size=(256, 128)), jnp.float32), 8)
    got = ops.mpmm(_t(x), _t(jd), _t(js), w_bits=8, dataflow="auto").numpy()
    exp = np.asarray(jops.mpmm(jnp.asarray(x), jd, js, w_bits=8, dataflow="auto",
                               interpret=True))
    np.testing.assert_allclose(got, exp, **F32_TOL)


# ---------------------------------------------------------- mpmm, int mode
def _int_case(m, k, n, w_bits, x_bits):
    xlim = 2 ** (x_bits - 1) - 1
    x = RNG.integers(-xlim, xlim, (m, k)).astype(np.int16 if x_bits == 16 else np.int8)
    wlim = 7 if w_bits == 4 else 2 ** (w_bits - 1) - 1
    wq = RNG.integers(-wlim - 1, wlim + 1, (k, n)).astype(np.int16 if w_bits == 16 else np.int8)
    wd = np.asarray(jpack_int4(jnp.asarray(wq.astype(np.int8)), axis=0)) if w_bits == 4 else wq
    return x, wd


@pytest.mark.parametrize("dataflow", ["cf", "ff"])
@pytest.mark.parametrize("w_bits,x_bits", [(16, 16), (8, 8), (4, 8), (8, 16), (16, 8)])
def test_int_mode_bit_exact_matches_jax(w_bits, x_bits, dataflow):
    m, k, n = 32, 256, 128
    x, wd = _int_case(m, k, n, w_bits, x_bits)
    ws = RNG.random((1, n)).astype(np.float32) + 0.5
    exp = np.asarray(jops.mpmm(jnp.asarray(x), jnp.asarray(wd), jnp.asarray(ws),
                               w_bits=w_bits, x_bits=x_bits, mode="int",
                               dataflow=dataflow, interpret=True))
    got = ops.mpmm(_t(x), _t(wd), _t(ws), w_bits=w_bits, x_bits=x_bits, mode="int",
                   dataflow=dataflow)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)
    acc = ref.mpmm_ref(_t(x), _t(wd), _t(ws), w_bits=w_bits, mode="int")
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(jref.mpmm_ref(jnp.asarray(x), jnp.asarray(wd),
                                              jnp.asarray(ws), w_bits=w_bits, mode="int")))


@pytest.mark.parametrize("dataflow", ["cf", "ff"])
def test_int_wraparound_matches_jax(dataflow):
    """All-32767 operands: every dot product (256 * 32767^2) wraps mod 2^32."""
    m, k, n = 8, 256, 128
    x = np.full((m, k), 32767, np.int16)
    wq = np.full((k, n), 32767, np.int16)
    ws = np.ones((1, n), np.float32)
    exp = np.asarray(jops.mpmm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), w_bits=16,
                               x_bits=16, mode="int", dataflow=dataflow, interpret=True))
    got = ops.mpmm(_t(x), _t(wq), _t(ws), w_bits=16, x_bits=16, mode="int",
                   dataflow=dataflow).numpy()
    np.testing.assert_array_equal(got, exp)
    acc = ref.mpmm_ref(_t(x), _t(wq), _t(ws), w_bits=16, mode="int")
    assert int(acc[0, 0]) == -16776960 == (k * 32767 * 32767 + 2**31) % 2**32 - 2**31


def test_int_mode_rejects_what_it_cannot_hold():
    x = torch.zeros(2, 8, dtype=torch.int16)
    wd, ws = torch.zeros(8, 4, dtype=torch.int8), torch.ones(1, 4)
    with pytest.raises(ValueError, match="x_bits=8"):
        ops.mpmm(x, wd, ws, w_bits=8, x_bits=8, mode="int")
    with pytest.raises(TypeError, match="int8 or int16"):
        ops.mpmm(x.float(), wd, ws, w_bits=8, mode="int")
    with pytest.raises(TypeError, match="w16"):
        ops.mpmm(x, wd, ws, w_bits=16, mode="int")
    with pytest.raises(ValueError, match="w16 requires int mode"):
        ops.mpmm(x.float(), wd.to(torch.int16), ws, w_bits=16)
    with pytest.raises(ValueError, match="dataflow"):
        ops.mpmm(x.float(), wd, ws, w_bits=8, dataflow="kf")


# ------------------------------------------------------------------ mpconv
@pytest.mark.parametrize("mode", ["dequant", "int"])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("dataflow", ["ff", "cf", "auto"])
@pytest.mark.parametrize("ksize,stride,pad", [(1, 1, 0), (3, 1, 1), (5, 1, 2), (3, 2, 1)])
def test_mpconv_matches_jax(mode, w_bits, dataflow, ksize, stride, pad):
    n, h, w_, ci, co = 2, 10, 10, 12, 24
    w = RNG.normal(size=(ksize, ksize, ci, co)).astype(np.float32)
    jd, js = jops.conv_pack_weights(jnp.asarray(w), w_bits)
    wd, ws = ops.conv_pack_weights(_t(w), w_bits)
    np.testing.assert_array_equal(wd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(js))
    if mode == "int":
        x = RNG.integers(-32768, 32768, (n, h, w_, ci)).astype(np.int16)
    else:
        x = RNG.normal(size=(n, h, w_, ci)).astype(np.float32)
    kw = dict(w_bits=w_bits, ksize=ksize, stride=stride, padding=pad, mode=mode,
              dataflow=dataflow)
    exp = np.asarray(jops.mpconv(jnp.asarray(x), jd, js, interpret=True, **kw))
    got = ops.mpconv(_t(x), wd, ws, **kw).numpy()
    assert got.shape == exp.shape
    if mode == "int":
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, **F32_TOL)


@pytest.mark.parametrize("ksize,stride,pad", [(1, 1, 0), (3, 1, 1), (7, 2, 3), (3, 2, 0)])
def test_conv_patches_and_mpconv_ref_match_jax(ksize, stride, pad):
    x = RNG.normal(size=(2, 9, 11, 5)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    exp = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(xp), (ksize, ksize), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = ref.conv_patches(_t(x), ksize, stride, pad)
    np.testing.assert_array_equal(got.numpy(), exp)
    xi = RNG.integers(-32768, 32768, x.shape).astype(np.int16)
    gi = ref.conv_patches(_t(xi), ksize, stride, pad)
    assert gi.dtype == torch.int16
    np.testing.assert_array_equal(gi.numpy(), ref.conv_patches(_t(xi).float(), ksize,
                                                               stride, pad).numpy())
    w = RNG.normal(size=(ksize, ksize, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        ref.mpconv_ref(_t(x), _t(w), stride=stride, padding=pad).numpy(),
        np.asarray(jref.mpconv_ref(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                   padding=pad)), **F32_TOL)
    wi = RNG.integers(-128, 128, w.shape).astype(np.int8)
    np.testing.assert_array_equal(
        ref.mpconv_ref(_t(xi), _t(wi), stride=stride, padding=pad).numpy(),
        np.asarray(jref.mpconv_ref(jnp.asarray(xi), jnp.asarray(wi), stride=stride,
                                   padding=pad)))


# ------------------------------------------------------------- the network
@pytest.mark.parametrize("src,dst", [(112, 56), (64, 224), (55, 27), (12, 16), (28, 14),
                                     (7, 9), (224, 55)])
def test_resize_nearest_matches_jax(src, dst):
    x = RNG.normal(size=(2, src, src + 1, 3)).astype(np.float32)
    exp = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst + 2, 3), "nearest"))
    got = cnn.resize_nearest(_t(x), dst, dst + 2)
    np.testing.assert_array_equal(got.numpy(), exp)
    xi = _t((x * 1000).astype(np.int16))
    np.testing.assert_array_equal(cnn.resize_nearest(xi, dst, dst + 2).numpy(),
                                  np.asarray(jax.image.resize(
                                      jnp.asarray(xi.numpy()), (2, dst, dst + 2, 3),
                                      "nearest")))


TINY = [  # (name, cin, cout, k, h, w, stride, padding)
    ("c1", 3, 8, 7, 16, 16, 2, 3),  # input 12x12 resized up to 16x16
    ("c2", 8, 16, 3, 8, 8, 1, 1),
    ("c3", 16, 12, 1, 8, 8, 1, 0),
    ("c4", 16, 16, 5, 6, 6, 1, 2),  # resized 8 -> 6, channels tiled 12 -> 16
    ("c5", 16, 8, 3, 6, 6, 2, 1),
]


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("strategy", ["mixed", "ff", "cf"])
def test_run_network_matches_jax(strategy, w_bits):
    layers = [ConvLayer(*spec) for spec in TINY]
    jlayers = [JConvLayer(*spec) for spec in TINY]
    if w_bits == 4:  # int4 packs K in pairs: c1's K = 147 is odd
        layers, jlayers = layers[1:], jlayers[1:]
    jparams = [jops.conv_pack_weights(
        jnp.asarray(RNG.normal(size=(l.k, l.k, l.cin, l.cout)) / (l.k * math.sqrt(l.cin)),
                    jnp.float32), w_bits) for l in jlayers]
    x = RNG.normal(size=(2, 12, 12, jlayers[0].cin)).astype(np.float32)
    exp, jdec = jcnn.run_network("tiny", jnp.asarray(x), jparams, jlayers, w_bits=w_bits,
                                 strategy=strategy, interpret=True)
    params = cnn_params_from_numpy([(np.asarray(a), np.asarray(b)) for a, b in jparams], "cpu")
    got, dec = cnn.run_network("tiny", _t(x), params, layers, w_bits=w_bits,
                               strategy=strategy, device="cpu")
    assert dec == jdec
    exp = np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-4, atol=1e-4 * np.abs(exp).max())


@pytest.mark.parametrize("net", list(JNETS))
def test_w4_init_network_raises_in_both_packages(net):
    """int4 packs K in pairs; every network's first conv has an odd K."""
    with pytest.raises(ValueError, match="even to pack"):
        jcnn.init_network(net, jax.random.PRNGKey(0), w_bits=4)
    with pytest.raises(ValueError, match="even to pack"):
        cnn.init_network(net, 0, w_bits=4, device="cpu")


def test_init_network_is_seeded_and_packed():
    layers, a = cnn.init_network("ResNet18", 3, w_bits=8, device="cpu")
    _, b = cnn.init_network("ResNet18", 3, w_bits=8, device="cpu")
    assert len(layers) == len(a) == 20
    for (wd, ws), (wd2, ws2), l in zip(a, b, layers):
        assert wd.dtype == torch.int8 and wd.shape == (l.cin * l.k * l.k, l.cout)
        assert ws.shape == (1, l.cout) and torch.equal(wd, wd2) and torch.equal(ws, ws2)


def test_run_network_refuses_input_on_another_device():
    layers, params = cnn.init_network("ResNet18", 0, device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        cnn.run_network("ResNet18", torch.zeros(1, 8, 8, 3, device="meta"), params[:1],
                        layers[:1], device="cpu")


def test_cnn_cli_on_cpu_matches_the_jax_example(capsys):
    report = tcnn_cli.main(["--net", "ResNet18", "--layers", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert report["shape"] == (1, 56, 56, 64) and report["finite"]
    jlayers = JNETS["ResNet18"]()
    assert report["decisions"] == [
        f"{l.name}: {jperf.select_dataflow(l, JPrecision.INT8).name.lower()}"
        for l in jlayers[:3]]
    for prec in (JPrecision.INT16, JPrecision.INT8, JPrecision.INT4):
        r = jperf.evaluate_network(jlayers, prec, "mixed", jperf.SpeedModel())
        assert (f"modelled {prec.name}: {r['gops']:.1f} GOPS, "
                f"{r['area_eff']:.1f} GOPS/mm^2") in out
    assert "ResNet18: 20 conv layers, w8 quantized" in out
    assert "executed 3 layers -> activation (1, 56, 56, 64), finite=True" in out
