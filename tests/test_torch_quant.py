"""Quantization parity of the PyTorch port against the JAX package: int4
packing, per-column weight quantization (w4/w8), per-(token, head) KV
quantization (kv4/kv8) and the serve path's token quantizer all give
byte-identical payloads and scales."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.quant import pack as jpack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.quant import pack  # noqa: E402

RNG = np.random.default_rng(0)


def _same(jx, tx):
    a, b = np.asarray(jx), tx.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_unpack_int4(axis):
    x = RNG.integers(-8, 8, (6, 8, 4)).astype(np.int8)
    packed = pack.pack_int4(torch.from_numpy(x), dim=axis)
    _same(jpack.pack_int4(jnp.asarray(x), axis=axis), packed)
    _same(jpack.unpack_int4(jnp.asarray(np.asarray(packed)), axis=axis),
          pack.unpack_int4(packed, dim=axis))
    np.testing.assert_array_equal(pack.unpack_int4(packed, dim=axis).numpy(), x)


def test_pack_int4_rejects_odd_length():
    with pytest.raises(ValueError, match="even"):
        pack.pack_int4(torch.zeros(3, 2, dtype=torch.int8), dim=0)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_weights_byte_identical(bits, dtype):
    w = RNG.normal(size=(96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-30 floor
    jw = jnp.asarray(w).astype(dtype).astype(jnp.float32)
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).float()
    jd, js = jops.pack_weights(jw, bits)
    td, ts = ops.pack_weights(tw, bits)
    _same(jd, td)
    _same(js, ts)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_byte_identical(bits, dtype):
    kv = RNG.normal(size=(2, 7, 3, 16)).astype(np.float32)
    jq, js = jops.quantize_kv(jnp.asarray(kv).astype(dtype), bits)
    tq, ts = ops.quantize_kv(torch.from_numpy(kv).to(getattr(torch, dtype)), bits)
    _same(jq, tq)
    _same(js, ts)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_token_kv_byte_identical(bits, dtype):
    kv = (RNG.normal(size=(3, 5, 2, 32)) * 3).astype(np.float32)
    jq, js = jT._quantize_token_kv(jnp.asarray(kv).astype(dtype), bits)
    tq, ts = T._quantize_token_kv(torch.from_numpy(kv).to(getattr(torch, dtype)), bits)
    _same(jq, tq)
    _same(js, ts)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_byte_identical(bits):
    """The whole stacked tree, carried over with params_from_numpy: the
    port's quantize_params equals the JAX one leaf for leaf."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), n_layers=2)
    params = jT.init_params(cfg, jax.random.PRNGKey(1))
    theirs = params_from_numpy(jax.tree.map(np.asarray, jT.quantize_params(params, bits)), "cpu")
    ours = T.quantize_params(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), bits)

    def cmp(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                cmp(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, int):
            assert a == b, path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    cmp(theirs, ours, "")
    assert ours["blocks"]["wq"]["data"].dtype == torch.int8
    assert ours["embed"].dtype == torch.bfloat16  # bf16 leaves carried over exactly


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_w16_matches_jax(dtype):
    """A 16-bit quantized weight dict runs in int mode, as the reference's
    ``layers.dense`` runs it: x truncated toward zero to int32 (values
    that truncate to negative numbers and to zero included), the exact
    int32 product, times the f32 scale, cast to x.dtype.  The dict is built
    with numpy and carried across by ``params_from_numpy``.  float32 must
    match bit for bit; bf16 within one bf16 rounding step (rtol 2^-8), the
    cast being the only rounding after the exact integer product."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    rng = np.random.default_rng(16)
    k, n = 96, 40
    w = {"data": rng.integers(-32768, 32768, (k, n)).astype(np.int16),
         "scale": (rng.random((1, n)) * 1e-4).astype(np.float32), "bits": 16}
    x = (rng.normal(size=(2, 3, k)) * 40).astype(np.float32)
    x[0, 0, :8] = [-3.7, -0.4, 0.6, 0.99, -0.99, 2.5, -2.5, 0.0]  # -3, 0, 0, 0, 0, 2, -2, 0
    jx = jnp.asarray(x).astype(dtype)
    exp = np.asarray(jlayers.dense(jx, jax.tree.map(jnp.asarray, w)).astype(jnp.float32))
    ours = params_from_numpy({"w": w}, "cpu")["w"]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.dense(tx, ours)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, 3, n)
    trunc = tx.reshape(-1, k).to(torch.int32)[0, :8].tolist()
    assert trunc == [-3, 0, 0, 0, 0, 2, -2, 0]
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), exp)
    else:
        np.testing.assert_allclose(got.float().numpy(), exp, rtol=2.0**-8, atol=0)
