"""The training forward of the port (``transformer.forward`` /
``train_loss``, ``layers.chunked_cross_entropy``) against the JAX package's
``jax.value_and_grad`` of the same functions, on reduced configs in float32
with the JAX weights carried over by ``params_from_numpy`` and the batches of
both packages' ``make_batch`` (bit-equal tokens): dense with per-layer
windows (gemma3-1b cut to 6 layers: five local layers of window 64 at S = 96,
then a global one), moe with a dense first block (kimi-k2-1t-a32b), vlm
(paligemma-3b, 8 prefix embeddings) and audio (musicgen-medium).

Tolerance: the loss and every gradient leaf within ``rtol = atol = 1e-4``
(the two frameworks sum in other orders; the gradients pass through up to
six layers and the f32 log-sum-exp).  ``chunked_cross_entropy`` alone (its
value and its gradients in h and the unembedding, over six chunks with a
padded vocab and a ragged mask) within ``rtol = atol = 1e-5``.  ``remat``
"none", "dots" and "full" give the same gradients bit for bit (recomputing
a layer on the CPU repeats its arithmetic exactly).  The ssm and hybrid
families are in ``tests/test_torch_train_ssm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import make_batch as jmake  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import tree  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (arch, overrides of the reduced config, seq_len)
FAMILIES = {
    "dense_windows": ("gemma3-1b", dict(n_layers=6), 96),
    "moe_first_dense": ("kimi-k2-1t-a32b", {}, 32),
    "vlm": ("paligemma-3b", {}, 24),
    "audio": ("musicgen-medium", {}, 24),
}


def configs(name, **over):
    """(JAX config, port config): the reduced arch in float32."""
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(get_config(name).reduced(), **over),
            dataclasses.replace(tget(name).reduced(), **over))


def grads_of(params, batch, cfg):
    """The port's (loss, ce, aux, grads in flattening order)."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = tT.train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), m["ce"].detach(), m["aux"].detach(), grads


def compare_with_jax(name, over, seq, seed=0, batch=2, noise_factor=None):
    """The port's loss and gradients against JAX's: within ``TOL``; or, with
    ``noise_factor``, each gradient leaf's largest difference within that
    many times the largest change of JAX's own gradient when every parameter
    moves one ulp up, or one ulp down (an ill-conditioned model's float32
    noise floor)."""
    jcfg, tcfg = configs(name, **over)
    params = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    data = dict(vocab=jcfg.vocab, seq_len=seq, global_batch=batch, seed=seed + 1)
    jb = jmake(JData(**data), 3, jcfg)
    value_and_grad = jax.value_and_grad(lambda p: jT.train_loss(p, jb, jcfg), has_aux=True)
    (jl, jm), jg = value_and_grad(params)
    if noise_factor is not None:
        nudged = [jax.tree_util.tree_leaves(value_and_grad(jax.tree.map(
            lambda a, d=d: jnp.asarray(np.nextafter(np.asarray(a), np.float32(d))),
            params))[1]) for d in (np.inf, -np.inf)]
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    loss, ce, aux, tg = grads_of(tp, make_batch(DataConfig(**data), 3, tcfg, device="cpu"),
                                 tcfg)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    np.testing.assert_allclose(float(ce), float(jm["ce"]), **TOL)
    np.testing.assert_allclose(float(aux), float(jm["aux"]), **TOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (g, e) in enumerate(zip(tg, jleaves)):
        e = np.asarray(e)
        assert np.isfinite(e).all() and tuple(g.shape) == e.shape
        if noise_factor is None:
            np.testing.assert_allclose(g.numpy(), e, **TOL)
        else:
            noise = max(np.abs(np.asarray(n[i]) - e).max() for n in nudged)
            assert np.abs(g.numpy() - e).max() <= noise_factor * noise, (i, noise)
    return tcfg, tp


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_loss_and_grads_match_jax(family):
    name, over, seq = FAMILIES[family]
    compare_with_jax(name, over, seq)


def test_chunked_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    b, s, d, vpad, vocab = 2, 12, 16, 40, 33
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, vpad)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    kw = dict(vocab=vocab, max_chunk_elems=200)  # 6 chunks of 2 positions

    def jfn(h, w):
        return jlayers.chunked_cross_entropy(h, w, jnp.asarray(labels), jnp.asarray(mask), **kw)

    jv, (jgh, jgw) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tv = tlayers.chunked_cross_entropy(th, tw, torch.from_numpy(labels),
                                       torch.from_numpy(mask), **kw)
    tgh, tgw = torch.autograd.grad(tv, (th, tw))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **tol)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), **tol)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), **tol)
    assert float(tgw[:, vocab:].abs().max()) == 0.0  # the padded vocab takes no gradient
    whole = tlayers.chunked_cross_entropy(th, tw, torch.from_numpy(labels),
                                          torch.from_numpy(mask), vocab=vocab)
    np.testing.assert_allclose(float(whole.detach()), float(tv.detach()), **tol)  # one chunk


@pytest.mark.parametrize("family", ["dense_windows", "moe_first_dense"])
def test_remat_policies_give_the_same_gradients(family):
    name, over, seq = FAMILIES[family]
    _, cfg = configs(name, **over)
    params = tT.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(DataConfig(cfg.vocab, seq, 2, seed=4), 0, cfg, device="cpu")
    base = grads_of(params, batch, cfg)
    for remat in ("dots", "full"):
        got = grads_of(params, batch, dataclasses.replace(cfg, remat=remat))
        assert torch.equal(got[0], base[0])
        for g, e in zip(got[3], base[3]):
            assert torch.equal(g, e), remat
    with pytest.raises(ValueError, match="remat"):
        grads_of(params, batch, dataclasses.replace(cfg, remat="some"))
