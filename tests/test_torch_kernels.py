"""The port's plain kernel versions against the JAX package: the W4/W8
dequant matmul, paged decode and paged prefill, each against the JAX
``backend="xla"`` path and the Pallas kernel run in interpret mode (the way
tests/test_kernels_paged.py runs it on the CPU).  Inputs are numpy arrays
made from a seed and handed to both packages.  Tolerances are the
reference's own: 2e-3 for mpmm, 3e-3 for attention."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.quant.pack import pack_int4 as jpack_int4  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RNG = np.random.default_rng(0)
ATTN_TOL = dict(atol=3e-3, rtol=3e-3)
MPMM_TOL = dict(atol=2e-3, rtol=2e-3)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# -------------------------------------------------------------------- mpmm
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (5, 256, 96), (33, 384, 256)])
def test_mpmm_plain_matches_jax(w_bits, m, k, n):
    w = RNG.normal(size=(k, n)).astype(np.float32) / math.sqrt(k)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    jd, js = jops.pack_weights(jnp.asarray(w), w_bits)
    wd, ws = np.asarray(jd), np.asarray(js)
    got = ops.mpmm(_t(x), _t(wd), _t(ws), w_bits=w_bits).numpy()
    assert np.array_equal(ref.mpmm_ref(_t(x), _t(wd), _t(ws), w_bits=w_bits).numpy(), got)
    for backend, interp in (("xla", None), ("pallas", True)):
        exp = jops.mpmm(_j(x), _j(wd), _j(ws), w_bits=w_bits, backend=backend,
                        interpret=interp)
        np.testing.assert_allclose(got, np.asarray(exp), **MPMM_TOL, err_msg=backend)


def test_mpmm_leading_dims_and_unported_modes():
    x = torch.from_numpy(RNG.normal(size=(2, 3, 64)).astype(np.float32))
    wd, ws = ops.pack_weights(torch.from_numpy(RNG.normal(size=(64, 32)).astype(np.float32)), 8)
    out = ops.mpmm(x, wd, ws, w_bits=8)
    assert out.shape == (2, 3, 32)
    np.testing.assert_array_equal(
        out.reshape(6, 32).numpy(), ref.mpmm_ref(x.reshape(6, 64), wd, ws, w_bits=8).numpy()
    )
    for kw in ({"mode": "int"}, {"dataflow": "ff"}, {"dataflow": "auto"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.mpmm(x, wd, ws, w_bits=8, **kw)


# ------------------------------------------------------------ paged inputs
def _payload(shape, kv_bits):
    """(payload as the pool stores it, per-token scales or None)."""
    if kv_bits == 16:
        return RNG.normal(size=shape).astype(np.float32), None
    lim = 8 if kv_bits == 4 else 128
    x = RNG.integers(-lim, lim, shape).astype(np.int8)
    s = (RNG.random((*shape[:-1], 1)) * 0.1).astype(np.float32)
    if kv_bits == 4:
        x = np.asarray(jpack_int4(jnp.asarray(x), axis=-1))
    return x, s


def _pool_case(kv_bits, n_layers, n_pages, ps, hkv, d):
    kp, ks = _payload((n_layers, n_pages, ps, hkv, d), kv_bits)
    vp, vs = _payload((n_layers, n_pages, ps, hkv, d), kv_bits)
    return kp, vp, ks, vs


# ------------------------------------------------------------- paged decode
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("b,hkv,groups,d,ps,w", [(3, 2, 3, 32, 8, 4), (2, 1, 4, 64, 4, 5)])
def test_paged_decode_plain_matches_jax(kv_bits, window, b, hkv, groups, d, ps, w):
    n_layers, n_pages = 2, b * w + 2
    kp, vp, ks, vs = _pool_case(kv_bits, n_layers, n_pages, ps, hkv, d)
    nk, nks = _payload((b, hkv, d), kv_bits)
    nv, nvs = _payload((b, hkv, d), kv_bits)
    q = RNG.normal(size=(b, hkv * groups, d)).astype(np.float32)
    # distinct shuffled pages; the spare pages hold stale entries nobody owns
    tables = RNG.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    # empty row, mid-page row, full table: pages past each length are stale
    lengths = np.array([0, ps + 3, w * ps][:b], np.int32)
    args = (q, kp, vp, ks, vs, tables, lengths)
    for layer in (1,):  # a nonzero layer: the offset into the pool's layer dim
        got = ops.paged_mqa_decode(
            *map(_t, args), layer, _t(nk), _t(nv), _t(nks), _t(nvs),
            kv_bits=kv_bits, window=window,
        ).numpy()
        for backend, interp in (("xla", None), ("pallas", True)):
            exp = jops.paged_mqa_decode(
                *map(_j, args), layer, _j(nk), _j(nv), _j(nks), _j(nvs),
                kv_bits=kv_bits, window=window, backend=backend, interpret=interp,
            )
            np.testing.assert_allclose(got, np.asarray(exp), **ATTN_TOL,
                                       err_msg=f"{backend} layer={layer}")


def test_paged_decode_ignores_stale_entries_past_length():
    """Pool contents at or past a row's length never leak into its output:
    scribbling over them (including page 0, where zero-padded table slots
    point) leaves the result unchanged."""
    b, hkv, g, d, ps, w, kv_bits = 2, 2, 2, 32, 4, 4, 8
    kp, vp, ks, vs = _pool_case(kv_bits, 1, 9, ps, hkv, d)
    tables = np.array([[3, 5, 0, 0], [7, 1, 2, 0]], np.int32)
    lengths = np.array([6, 9], np.int32)
    nk, nks = _payload((b, hkv, d), kv_bits)
    q = _t(RNG.normal(size=(b, hkv * g, d)).astype(np.float32))

    def run(kp_):
        return ops.paged_mqa_decode(
            q, _t(kp_), _t(vp), _t(ks), _t(vs), _t(tables), _t(lengths), 0,
            _t(nk), _t(nk), _t(nks), _t(nks), kv_bits=kv_bits,
        )

    before = run(kp)
    dirty = kp.copy()
    dirty[0, 5, 2:] = 127  # row 0: positions 6, 7 of page 5 are past length 6
    dirty[0, 2, 1:] = -128  # row 1: positions 9.. of page 2
    dirty[0, 0] = 99  # page 0 backs every zero-padded slot
    np.testing.assert_array_equal(before.numpy(), run(dirty).numpy())


# ------------------------------------------------------------ paged prefill
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("c", [1, 5, 8])
def test_paged_prefill_plain_matches_jax(kv_bits, window, c):
    b, hkv, groups, d, ps, w, n_layers = 3, 2, 2, 32, 4, 5, 2
    n_pages = b * w + 1
    kp, vp, ks, vs = _pool_case(kv_bits, n_layers, n_pages, ps, hkv, d)
    ck, cks = _payload((b, c, hkv, d), kv_bits)
    cv, cvs = _payload((b, c, hkv, d), kv_bits)
    q = RNG.normal(size=(b, c, hkv * groups, d)).astype(np.float32)
    tables = RNG.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([0, 6, 11], np.int32)
    q_lens = np.array([c, max(c - 2, 1), (c + 1) // 2], np.int32)  # ragged
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens)
    for layer in (1,):  # a nonzero layer: the offset into the pool's layer dim
        got = ops.paged_mqa_prefill(
            *map(_t, args), layer, _t(ck), _t(cv), _t(cks), _t(cvs),
            kv_bits=kv_bits, window=window,
        ).numpy()
        assert np.isfinite(got).all()  # padding rows too
        valid = np.arange(c)[None, :] < q_lens[:, None]  # padding rows: unspecified
        for backend, interp in (("xla", None), ("pallas", True)):
            exp = np.asarray(jops.paged_mqa_prefill(
                *map(_j, args), layer, _j(ck), _j(cv), _j(cks), _j(cvs),
                kv_bits=kv_bits, window=window, backend=backend, interpret=interp,
            ))
            np.testing.assert_allclose(got[valid], exp[valid], **ATTN_TOL,
                                       err_msg=f"{backend} layer={layer}")


def test_gather_pages_layout():
    pool = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    tables = torch.tensor([[4, 0], [1, 2]], dtype=torch.int32)
    g = ref.gather_pages(pool, tables)
    assert g.shape == (2, 2, 6)
    assert g[1, 0].tolist() == pool[1, 4].tolist() + pool[1, 0].tolist()
