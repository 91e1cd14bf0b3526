"""The paper's executable core in the PyTorch port against the JAX package:
``core/sau.py`` (the 4-bit multiplier combination), ``core/assembler.py``
and ``core/interpreter.py`` (VSACFG / VSALD / VSAM programs and their
simulator) and ``quant/quantize.py``.

Everything here is integer or exactly rounded, so the bar is bit-exactness:
digits, products, accumulators and tile matmuls over the precisions of
tests/test_sau.py; the assembled instruction words, rs1 values, stores and
memory image word for word and the simulated outputs bit for bit, over
tests/test_interpreter.py's precision x dataflow x kernel-size grid (and its
ragged and bit-accurate cases); payloads, scales and fake-quantized values
of tests/test_quant.py's cases on float32 inputs.  Inputs come from numpy
seeds; the JAX package's Precision and Dataflow map to the port's by name."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import sau as jsau  # noqa: E402
from repro.core.assembler import assemble_conv as jassemble  # noqa: E402
from repro.core.dataflow import ConvLayer as JConvLayer  # noqa: E402
from repro.core.interpreter import run_program as jrun  # noqa: E402
from repro.core.isa import Dataflow as JDataflow  # noqa: E402
from repro.core.precision import Precision as JPrecision  # noqa: E402
from repro.quant import pack_int4_hi_lo as jhi_lo  # noqa: E402
from repro_torch.core import sau  # noqa: E402
from repro_torch.core.assembler import assemble_conv  # noqa: E402
from repro_torch.core.dataflow import ConvLayer  # noqa: E402
from repro_torch.core.interpreter import run_program  # noqa: E402
from repro_torch.core.isa import Dataflow, decode  # noqa: E402
from repro_torch.core.precision import Precision  # noqa: E402
from repro_torch.quant import (  # noqa: E402
    QTensor,
    absmax_scale,
    dequantize,
    fake_quantize,
    pack_int4_hi_lo,
    quantize,
    quantize_per_channel,
)

PRECS = [Precision.INT4, Precision.INT8, Precision.INT16]
# the module (``repro.quant`` exports a function of the same name)
jq = importlib.import_module("repro.quant.quantize")


def _jp(prec):
    return JPrecision[prec.name]


def _ints(prec, shape, seed):
    s = prec.spec
    return np.random.default_rng(seed).integers(s.qmin, s.qmax + 1, shape).astype(np.int32)


# ------------------------------------------------------------------ SAU
@pytest.mark.parametrize("prec", PRECS)
def test_digits_and_pe_products_match_jax(prec):
    """Every operand pair at 4 bits, and 4096 random pairs plus the extremes
    at 8 and 16: digits, their composition, products and MACs bit-exact."""
    s = prec.spec
    if prec is Precision.INT4:
        vals = np.arange(s.qmin, s.qmax + 1, dtype=np.int32)
        a, b = np.meshgrid(vals, vals)
    else:
        ext = np.array([s.qmin, s.qmax, -1, 0, 1], np.int32)
        a = np.concatenate([_ints(prec, 4096, 1), np.repeat(ext, 5)])
        b = np.concatenate([_ints(prec, 4096, 2), np.tile(ext, 5)])
    digits = sau.digit_decompose(torch.from_numpy(a), s.bits)
    assert digits.dtype == torch.int32
    assert np.array_equal(digits.numpy(), np.asarray(jsau.digit_decompose(jnp.asarray(a), s.bits)))
    assert np.array_equal(sau.digit_compose(digits).numpy(), a)
    got = sau.pe_multiply(torch.from_numpy(a), torch.from_numpy(b), prec)
    exp = np.asarray(jsau.pe_multiply(jnp.asarray(a), jnp.asarray(b), _jp(prec)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), exp)
    assert np.array_equal(got.numpy().astype(np.int64), a.astype(np.int64) * b)
    acc = _ints(Precision.INT16, a.shape, 3) * 65536  # near the int32 range: wraps alike
    got = sau.pe_mac(torch.from_numpy(acc), torch.from_numpy(a), torch.from_numpy(b), prec)
    exp = jsau.pe_mac(jnp.asarray(acc), jnp.asarray(a), jnp.asarray(b), _jp(prec))
    assert np.array_equal(got.numpy(), np.asarray(exp))
    hi, lo = pack_int4_hi_lo(torch.from_numpy(a))
    jhi, jlo = jhi_lo(jnp.asarray(a))
    assert np.array_equal(hi.numpy(), np.asarray(jhi)) and np.array_equal(lo.numpy(), np.asarray(jlo))


@pytest.mark.parametrize("bit_accurate", [False, True])
@pytest.mark.parametrize("prec", PRECS)
def test_sau_matches_jax(prec, bit_accurate):
    """The tile matmul-accumulate of tests/test_sau.py (4 x 6 by 6 x 4) and
    one whose int32 accumulator wraps; the cycle model."""
    tile, jtile = sau.SAU(tile_r=4, tile_c=4), jsau.SAU(tile_r=4, tile_c=4)
    for seed, acc_scale in ((1, 0), (4, 1 << 30)):
        a, b = _ints(prec, (4, 6), seed), _ints(prec, (6, 4), seed + 1)
        acc = _ints(Precision.INT8, (4, 4), seed + 2) * acc_scale
        got = tile(torch.from_numpy(acc), torch.from_numpy(a), torch.from_numpy(b), prec,
                   bit_accurate=bit_accurate)
        exp = jtile(jnp.asarray(acc), jnp.asarray(a), jnp.asarray(b), _jp(prec),
                    bit_accurate=bit_accurate)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(exp))
    for r, c, k in ((4, 4, 100), (8, 4, 100), (5, 9, 7)):
        assert tile.cycles(r, c, k, prec) == jtile.cycles(r, c, k, _jp(prec))
    with pytest.raises(ValueError):
        sau.SAU(tile_r=2, tile_c=2)(torch.zeros(4, 4, dtype=torch.int32),
                                    torch.zeros(4, 3, dtype=torch.int32),
                                    torch.zeros(3, 4, dtype=torch.int32), prec)


# ---------------------------------------------------- assembler + interpreter
def _program_case(prec, df, cin, cout, h, w, k, pad, seed):
    rng = np.random.default_rng(seed)
    lim = min(prec.spec.qmax, 50)
    x = rng.integers(-lim, lim + 1, (cin, h, w)).astype(np.int32)
    wt = rng.integers(-lim, lim + 1, (cout, cin, k, k)).astype(np.int32)
    ours = assemble_conv(ConvLayer("t", cin, cout, k, h, w, 1, pad), x, wt, prec, df)
    theirs = jassemble(JConvLayer("t", cin, cout, k, h, w, 1, pad), x, wt, _jp(prec),
                       JDataflow[df.name])
    return ours, theirs


def _check_program(ours, theirs, bit_accurate=False):
    assert ours.words == theirs.words
    assert ours.rs1_values == theirs.rs1_values
    assert [dataclasses.astuple(s) for s in ours.stores] == [
        dataclasses.astuple(s) for s in theirs.stores]
    assert np.array_equal(ours.memory, theirs.memory)
    assert (ours.w_pad, ours.h_pad, ours.ce) == (theirs.w_pad, theirs.h_pad, theirs.ce)
    got = run_program(ours, bit_accurate=bit_accurate)
    assert got.dtype == np.int64
    assert np.array_equal(got, jrun(theirs, bit_accurate=bit_accurate))
    return got


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("df", [Dataflow.FF, Dataflow.CF])
@pytest.mark.parametrize("k,pad", [(1, 0), (3, 1), (3, 0), (5, 2)])
def test_program_words_and_outputs_match_jax(prec, df, k, pad):
    """tests/test_interpreter.py's grid: 8 -> 8 channels at 6 x 6 (8 x 8 at
    k 5); the words decode to the three custom instructions."""
    h = w = 8 if k == 5 else 6
    ours, theirs = _program_case(prec, df, 8, 8, h, w, k, pad, seed=k * 10 + pad)
    _check_program(ours, theirs)
    assert {type(decode(wd)).__name__ for wd in ours.words} == {"VSACFG", "VSALD", "VSAM"}


@pytest.mark.parametrize("df", [Dataflow.FF, Dataflow.CF])
def test_ragged_program_and_bit_accurate_products_match_jax(df):
    """cin 6 pads to 8 at INT8 (g = 4) and cout 10 is not a multiple of
    oc_par; then every product through the 4-bit digit identity (the
    port's sau.pe_multiply), which changes no output."""
    ours, theirs = _program_case(Precision.INT8, df, 6, 10, 6, 6, 3, 1, seed=7)
    _check_program(ours, theirs)
    ours, theirs = _program_case(Precision.INT8, df, 4, 4, 4, 4, 3, 1, seed=3)
    exact = _check_program(ours, theirs, bit_accurate=True)
    assert np.array_equal(exact, run_program(ours))


# ------------------------------------------------------------- quantize
def _floats(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _check_q(got: QTensor, exp):
    assert got.precision.name == exp.precision.name and got.packed == exp.packed
    assert np.array_equal(got.data.numpy(), np.asarray(exp.data))
    assert got.data.dtype == {np.dtype("int8"): torch.int8,
                              np.dtype("int16"): torch.int16}[np.asarray(exp.data).dtype]
    assert np.array_equal(got.scale.numpy(), np.asarray(exp.scale))
    assert got.logical_shape == exp.logical_shape and got.nbytes == exp.nbytes
    assert np.array_equal(dequantize(got).numpy(), np.asarray(jq.dequantize(exp)))


@pytest.mark.parametrize("prec", PRECS)
def test_quantize_matches_jax(prec):
    """Per-tensor and per-channel (both axes) on float32, an odd last axis
    (INT4 stays unpacked), a given scale, pack=False; dequantize and
    fake_quantize equal too."""
    jp = _jp(prec)
    x = _floats((16, 32), 1, 3.0) * np.linspace(0.01, 10, 32, dtype=np.float32)
    t = torch.from_numpy(x)
    assert np.array_equal(absmax_scale(t, prec).numpy(), np.asarray(jq.absmax_scale(x, jp)))
    _check_q(quantize(t, prec), jq.quantize(jnp.asarray(x), jp))
    _check_q(quantize(t, prec, pack=False), jq.quantize(jnp.asarray(x), jp, pack=False))
    _check_q(quantize(t, prec, scale=torch.tensor(0.05)),
             jq.quantize(jnp.asarray(x), jp, scale=jnp.float32(0.05)))
    odd = _floats((4, 7), 2)
    _check_q(quantize(torch.from_numpy(odd), prec), jq.quantize(jnp.asarray(odd), jp))
    for axis in (-1, 0):
        _check_q(quantize_per_channel(t, prec, channel_axis=axis),
                 jq.quantize_per_channel(jnp.asarray(x), jp, channel_axis=axis))
    for axis in (None, -1, 0):
        got = fake_quantize(t, prec, channel_axis=axis)
        exp = np.asarray(jq.fake_quantize(jnp.asarray(x), jp, channel_axis=axis))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), exp)


def test_quantize_cases_of_the_reference_tests():
    """tests/test_quant.py's fixed cases through both packages: per-channel
    scales beating per-tensor, the halved INT4 payload, fake-quantize
    idempotent on its grid.  (An all-zero input is left out: its scale,
    float32's tiny over qmax, is subnormal; XLA flushes it to 0 and PyTorch
    keeps it, with the same all-zero payload.)"""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 8)) * np.array([0.01, 1, 100, 0.1, 10, 1, 1, 1])).astype(np.float32)
    t = torch.from_numpy(x)
    pt, pc = quantize(t, Precision.INT8), quantize_per_channel(t, Precision.INT8)
    _check_q(pt, jq.quantize(jnp.asarray(x), JPrecision.INT8))
    _check_q(pc, jq.quantize_per_channel(jnp.asarray(x), JPrecision.INT8))
    assert (dequantize(pc) - t).abs().mean() < (dequantize(pt) - t).abs().mean()
    y = torch.from_numpy(_floats((16, 32), 1))
    q4, q8 = quantize(y, Precision.INT4), quantize(y, Precision.INT8)
    assert q4.packed and tuple(q4.data.shape) == (16, 16) and q4.logical_shape == (16, 32)
    assert q4.data.numel() == q8.data.numel() // 2
    grid = np.array([-3.0, -0.5, 0.0, 1.5, 63.5], np.float32)
    fq = fake_quantize(torch.from_numpy(grid), Precision.INT8)
    assert np.array_equal(fq.numpy(), np.asarray(jq.fake_quantize(jnp.asarray(grid),
                                                                  JPrecision.INT8)))
    assert torch.equal(fake_quantize(fq, Precision.INT8), fq)
