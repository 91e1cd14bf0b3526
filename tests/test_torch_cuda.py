"""Each hand-written CUDA kernel of repro_torch against its plain PyTorch
version, on the card: the W4/W8 dequant matmul, paged decode and paged
prefill, at small ragged shapes and at llama3.2-3b's widths.

Marked ``cuda``: on a machine without a card every test skips with a
reason.  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: the outputs are bf16 and the kernel sums in f32 in another order
than the plain version, so one bf16 rounding step either way is expected:
``atol = rtol = 1e-2``.
"""
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.mpmm import mpmm_cuda  # noqa: E402
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


def test_mpmm_rejects_unported_modes(dev):
    x = torch.zeros(2, 8, dtype=torch.bfloat16, device=dev)
    wd = torch.zeros(8, 8, dtype=torch.int8, device=dev)
    ws = torch.ones(1, 8, device=dev)
    for kw in ({"mode": "int"}, {"dataflow": "ff"}, {"dataflow": "auto"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.mpmm(x, wd, ws, w_bits=8, **kw)
    with pytest.raises(TypeError):
        mpmm_cuda(x.float(), wd, ws, w_bits=8)


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
