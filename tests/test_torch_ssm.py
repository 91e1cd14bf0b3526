"""The port's Mamba2 blocks and contiguous-cache attention against the JAX
package, on inputs made with numpy from a seed and handed to both.

SSM pieces run in float32 (the recurrence is float32 in both packages);
they agree within 1e-4 relative to the largest output magnitude (the two
frameworks sum the einsums in other orders).  Attention: float32 within
1e-5 (``flash_attention``, the unquantized branch and the windowed int8
branch of ``decode_attention``, which compute the same expression as JAX),
and the int8 branch without a window, which runs ``ops.mqa_decode``'s plain
version, within the attention tolerance the reference's own kernel tests
use (``atol=rtol=3e-3``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SSM_RTOL = 1e-4
ATTN_TOL = dict(atol=3e-3, rtol=3e-3)


def _close_rel(got, exp, rtol=SSM_RTOL):
    """Within rtol of the largest |expected| value, elementwise."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape
    scale = max(np.abs(exp).max(), 1e-30)
    err = np.abs(got - exp).max()
    assert err <= rtol * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- SSD
@pytest.mark.parametrize("s,chunk", [(37, 16), (32, 16), (5, 128)])
def test_ssd_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 5
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)  # softplus > 0
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.5
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bb, cc)), chunk,
                               return_state=True)
    ty, tst = tssm.ssd_chunked(*map(_t, (x, dt, a_log, bb, cc)), chunk, return_state=True)
    _close_rel(ty.numpy(), jy)
    _close_rel(tst.numpy(), jst)
    # without return_state: y alone, the same values
    np.testing.assert_array_equal(
        tssm.ssd_chunked(*map(_t, (x, dt, a_log, bb, cc)), chunk).numpy(), ty.numpy())


def _ssm_params(dims, rng, w_bits):
    """JAX block parameters with random vectors (the init's are constants)
    and, for w_bits < 16, int8/int4 projections; both packages' trees."""
    jp = jssm.init_ssm_params(jax.random.PRNGKey(int(rng.integers(1 << 30))), dims,
                              jnp.float32)
    h, di = dims.n_heads, dims.d_inner
    jp["A_log"] = jnp.asarray(rng.normal(size=(h,)) * 0.5, jnp.float32)
    jp["D"] = jnp.asarray(rng.normal(size=(h,)), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.normal(size=(h,)), jnp.float32)
    jp["norm"] = jnp.asarray(1 + 0.1 * rng.normal(size=(di,)), jnp.float32)
    if w_bits < 16:
        from repro.models.layers import quantize_dense_weight

        for name in ("in_proj", "out_proj"):
            jp[name] = quantize_dense_weight(jp[name], w_bits)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("w_bits", [16, 8, 4])
def test_ssm_block_prefill_and_decode_match_jax(w_bits):
    rng = np.random.default_rng(w_bits)
    dims = jssm.ssm_dims(64, 16, 16)  # d_inner 128, 8 heads of 16
    assert tuple(tssm.ssm_dims(64, 16, 16)) == tuple(dims)
    jp, tp = _ssm_params(dims, rng, w_bits)
    x = rng.normal(size=(2, 21, 64)).astype(np.float32)
    jy, jst = jssm.ssm_block_with_state(jp, jnp.asarray(x), dims, chunk=8)
    ty, tst = tssm.ssm_block_with_state(tp, _t(x), dims, chunk=8)
    _close_rel(ty.numpy(), jy)
    _close_rel(tst.numpy(), jst)
    _close_rel(tssm.ssm_block(tp, _t(x), dims, chunk=8).numpy(),
               jssm.ssm_block(jp, jnp.asarray(x), dims, chunk=8))
    # two decode steps from the prefill state
    jstate, tstate = jst, tst
    for i in range(2):
        x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, jstate = jssm.ssm_decode_step(jp, jnp.asarray(x1), jstate, dims)
        to, tstate = tssm.ssm_decode_step(tp, _t(x1), tstate, dims)
        _close_rel(to.numpy(), jo)
        _close_rel(tstate.numpy(), jstate)


def test_padded_chunk_steps_keep_the_state():
    """dt = 0 on the padded tail: the final state of S tokens equals the
    state after the same S tokens padded up to a chunk multiple."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 11, 2, 4, 3
    x = _t(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = _t(rng.random((b, s, h)).astype(np.float32))
    a_log = _t(rng.normal(size=(h,)).astype(np.float32))
    bb, cc = (_t(rng.normal(size=(b, s, n)).astype(np.float32)) for _ in range(2))
    _, st = tssm.ssd_chunked(x, dt, a_log, bb, cc, chunk=8, return_state=True)
    _, st_full = tssm.ssd_chunked(x, dt, a_log, bb, cc, chunk=11, return_state=True)
    _close_rel(st.numpy(), st_full.numpy())


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 5, 0),
                                                    (False, None, 0), (True, None, 3)])
def test_flash_attention_matches_jax(causal, window, q_offset):
    rng = np.random.default_rng(7)
    b, sq, sk, h, hkv, d = 2, 13, 13 + q_offset, 4, 2, 16
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=4, block_k=8)
    exp = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.flash_attention(*map(_t, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


def _decode_case(rng, b, s, h, hkv, d):
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("length", [[9, 4], 7])
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_unquantized_matches_jax(length, window):
    rng = np.random.default_rng(11)
    q, k, v = _decode_case(rng, 2, 12, 4, 2, 16)
    exp = jattn.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(length),
                                 window=window)
    got = tattn.decode_attention(*map(_t, (q, k, v)), torch.tensor(length), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("groups", [1, 2])
def test_decode_attention_int8_matches_jax(window, groups):
    """The quantized branch: ops.mqa_decode (the kernel's plain version on
    the CPU) without a window, the JAX expression with one."""
    rng = np.random.default_rng(13 + groups)
    hkv = 2
    q, k, v = _decode_case(rng, 2, 12, hkv * groups, hkv, 32)
    kd, ks = jops.quantize_kv(jnp.asarray(k), 8)
    vd, vs = jops.quantize_kv(jnp.asarray(v), 8)
    length = 9  # a scalar, broadcast over the batch (the wave's shared position)
    exp = jattn.decode_attention(jnp.asarray(q), kd, vd, jnp.asarray(length), window=window,
                                 k_scale=ks, v_scale=vs)
    tq, tkd, tvd, tks, tvs = map(_t, (q, kd, vd, ks, vs))
    got = tattn.decode_attention(tq, tkd, tvd, length, window=window, k_scale=tks,
                                 v_scale=tvs)
    tol = ATTN_TOL if window is None else dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **tol)
    if window is None:  # this branch is exactly ops.mqa_decode
        lengths = torch.full((2,), length, dtype=torch.int32)
        np.testing.assert_array_equal(
            got.reshape(2, -1, 32).numpy(),
            ops.mqa_decode(tq.reshape(2, -1, 32), tkd, tvd, tks, tvs, lengths).numpy())
