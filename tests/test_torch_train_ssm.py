"""The training forward of the ssm and hybrid families (mamba2-130m,
zamba2-7b, reduced, float32) against ``jax.value_and_grad`` of the JAX
package's ``train_loss``, with the JAX weights carried over, at S = 48: the
loss and every gradient leaf within ``rtol = atol = 1e-4``, as for the other
families (``tests/test_torch_train_model.py``); the hybrid's gradient leaves
within its float32 noise floor instead (see its test).

At S = 48 JAX's gradient is finite; at S >= 64 on these configs it is not:
the reference's SSD builds its intra-chunk decays as ``where(tri, exp(li),
0)``, whose ``exp`` overflows above the diagonal and whose backward then
multiplies the zero cotangent by inf.  The port masks before the exponential
(``models/ssm.py``): at S = 256 JAX's gradient has non-finite leaves and
the port's has none, the port's ``ssd_chunked`` gives the unmasked form's
outputs bit for bit, and its backward passes ``torch.autograd.gradcheck`` in
float64 on a tiny input.  Remat none / dots / full give bit-equal grads on
the hybrid (its remat covers a whole group with the shared block).
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import make_batch as jmake  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from test_torch_train_model import compare_with_jax, configs, grads_of  # noqa: E402


def test_ssm_train_loss_and_grads_match_jax():
    compare_with_jax("mamba2-130m", {}, 48)


def test_hybrid_train_loss_and_grads_match_jax():
    """The hybrid's gradient is ill-conditioned at this size: moving every
    parameter one ulp moves JAX's own embedding gradient by ~1e-2, and
    against a float64 run of the port either package lands 40-100x closer
    than the other, depending on that ulp (the two swap places when the
    parameters move).  So the loss is held to 1e-4 and each gradient leaf to
    8x JAX's own one-ulp response (the port's rounding differs at every op,
    not only in the inputs; measured: at most 3.1x)."""
    compare_with_jax("zamba2-7b", {}, 48, noise_factor=8)


def _ssd_unmasked(x, dt, a_log, b, c, chunk):
    """The reference's SSD (``where(tri, exp(li), 0)``), without the final
    state: the port's function before it masked ahead of the exponential."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    x, dt = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)), torch.nn.functional.pad(dt, (0, 0, 0, pad))
    b, c = torch.nn.functional.pad(b, (0, 0, 0, pad)), torch.nn.functional.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // q
    loga = dt * -torch.exp(a_log)[None, None, :]
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    state = torch.zeros(bs, h, p, n, dtype=x.dtype)
    ys = []
    for ci in range(nc):
        sl = slice(ci * q, (ci + 1) * q)
        xq, dtq, laq, bq, cq = x[:, sl], dt[:, sl], loga[:, sl], b[:, sl], c[:, sl]
        cum = torch.cumsum(laq, dim=1)
        total = cum[:, -1]
        li = cum[:, :, None, :] - cum[:, None, :, :]
        lmat = torch.where(tri[None, :, :, None], torch.exp(li), 0.0)
        gates = torch.einsum("bin,bjn->bij", cq, bq)[..., None] * lmat * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", gates, xq)
        y_state = torch.einsum("bin,bhpn,bih->bihp", cq, state, torch.exp(cum))
        w = torch.exp(total[:, None, :] - cum) * dtq
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjn,bjhp,bjh->bhpn", bq, xq, w)
        ys.append(y_intra + y_state)
    return torch.stack(ys, dim=1).reshape(bs, nc * q, h, p)[:, :s]


def test_ssd_forward_bit_identical_to_the_unmasked_form():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 300, 4, 8, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(2, 300, 4, generator=g) + 1.5)
    a_log, b, c = torch.randn(4, generator=g), torch.randn(2, 300, 16, generator=g), \
        torch.randn(2, 300, 16, generator=g)
    exp = _ssd_unmasked(x, dt, a_log, b, c, 128)
    # a first chunk whose decay overflows exp above the diagonal (exp(88.7) = inf)
    assert (torch.cumsum(dt * a_log.exp(), 1)[:, 127] > 89).any()
    got = ssm_mod.ssd_chunked(x, dt, a_log, b, c, 128)
    assert torch.equal(got, exp)


def test_ssd_backward_passes_gradcheck_in_float64():
    g = torch.Generator().manual_seed(1)
    args = [torch.randn(1, 6, 2, 3, generator=g, dtype=torch.float64),
            torch.rand(1, 6, 2, generator=g, dtype=torch.float64) + 0.5,
            torch.randn(2, generator=g, dtype=torch.float64),
            torch.randn(1, 6, 4, generator=g, dtype=torch.float64),
            torch.randn(1, 6, 4, generator=g, dtype=torch.float64)]
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(lambda *a: ssm_mod.ssd_chunked(*a, chunk=4), args)


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-7b"])
def test_gradient_finite_where_the_reference_is_not(name):
    jcfg, tcfg = configs(name)
    params = jT.init_params(jcfg, jax.random.PRNGKey(0))
    data = dict(vocab=jcfg.vocab, seq_len=256, global_batch=1, seed=1)
    jb = jmake(JData(**data), 0, jcfg)
    (jl, _), jg = jax.value_and_grad(lambda p: jT.train_loss(p, jb, jcfg), has_aux=True)(params)
    assert not all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(jg))
    from repro_torch.models.convert import params_from_numpy

    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    loss, _, _, tg = grads_of(tp, make_batch(DataConfig(**data), 0, tcfg, device="cpu"), tcfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-4)
    assert all(bool(torch.isfinite(x).all()) for x in tg)


def test_hybrid_remat_policies_give_the_same_gradients():
    _, cfg = configs("zamba2-7b", n_layers=5)  # two groups of 2 and a tail of 1
    params = tT.init_params(cfg, torch.Generator().manual_seed(0))
    assert "tail" in params
    batch = make_batch(DataConfig(cfg.vocab, 40, 2, seed=4), 0, cfg, device="cpu")
    base = grads_of(params, batch, cfg)
    for remat in ("dots", "full"):
        got = grads_of(params, batch, dataclasses.replace(cfg, remat=remat))
        assert torch.equal(got[0], base[0])
        assert all(torch.equal(a, b) for a, b in zip(got[3], base[3])), remat
