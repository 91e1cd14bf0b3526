"""The port's train step (``repro_torch/train/trainer.py``) against the JAX
package's, on the JAX trainer tests' tiny llama (2 layers, d_model 64, vocab
256, batch 8 x 64).

Against JAX, in float32 with the JAX weights carried over: one step of
``make_train_step`` under each optimizer (adamw, adamw8bit, adafactor), and
three steps under adamw and adafactor (warm-up 1, so the first step's LR is
0), with 1 and 2 microbatches: the loss and grad norm within ``rtol = atol =
1e-5`` and every updated parameter within ``1e-5``, except, under the Adam
optimizers, where JAX's gradient of some step lies below 1e-6 (100 x
Adam's eps): there ``g / (|g| + eps)`` follows the last bits of a cancelling
sum, and the two may differ by up to 2 x lr a step; ``_global_norm`` and
``_clip_by_global_norm`` within ``1e-6``.  The loop, the launcher and the
JAX trainer tests' own rules are in ``tests/test_torch_train_loop.py``.
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
from repro.models import transformer as jT  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim import tree  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=256, n_heads=2, n_kv_heads=2,
            head_dim=32)
TOL = dict(rtol=1e-5, atol=1e-5)
# Adam's step is g / (|g| + eps) per element: where |g| is below 100 eps its
# last bits, set by a cancelling sum, move the update by up to 2 lr
SIGN_LIKE = 1e-6


def _arch(get, **over):
    return dataclasses.replace(get("llama3.2-3b").reduced(), **TINY, **over)


def _steps_against_jax(optimizer, steps, warmup, microbatches):
    over = dict(dtype="float32", optimizer=optimizer)
    jarch, tarch = _arch(get_config, **over), _arch(tget, **over)
    kw = dict(lr=3e-3, warmup=warmup, total_steps=10, grad_clip=1.0,
              microbatches=microbatches)
    jstep, jinit = jmake_train_step(jarch, JTrainConfig(**kw))
    tstep, tinit = make_train_step(tarch, TrainConfig(**kw))
    jparams = jT.init_params(jarch, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jst, tst = jinit(jparams), tinit(tparams)
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: jT.train_loss(p, b, jarch)[0]))
    data = dict(vocab=256, seq_len=64, global_batch=8, seed=2)
    tiny = jax.tree.map(lambda p: np.zeros(p.shape, bool), jparams)
    for step in range(steps):
        jb = jmake(JData(**data), step)
        tiny = jax.tree.map(lambda t, g: t | (np.abs(np.asarray(g)) < SIGN_LIKE), tiny,
                            jgrad(jparams, jb))
        jparams, jst, jm = jstep(jparams, jst, jb, jnp.asarray(step, jnp.int32))
        tparams, tst, tm = tstep(tparams, tst, make_batch(DataConfig(**data), step,
                                                          device="cpu"), step)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    got, exp = params_to_numpy(tparams), jax.tree.map(np.asarray, jparams)
    for g, e, t in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(exp),
                       jax.tree_util.tree_leaves(tiny)):
        if optimizer == "adafactor":  # its denominator is a row / column statistic
            t = np.zeros_like(t)
        np.testing.assert_allclose(g[~t], e[~t], **TOL)
        assert np.abs(g[t] - e[t]).max(initial=0) <= 2 * kw["lr"] * steps
    assert int(tst.step) == int(jst.step) == steps


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "adafactor"])
def test_one_step_matches_jax(optimizer):
    _steps_against_jax(optimizer, 1, 0, 1)


@pytest.mark.parametrize("optimizer,microbatches", [("adamw", 1), ("adamw", 2),
                                                    ("adafactor", 1)])
def test_three_steps_match_jax(optimizer, microbatches):
    _steps_against_jax(optimizer, 3, 1, microbatches)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(0)
    g_np = {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "b": {"c": (rng.normal(size=(5,)) * 3).astype(np.float32)}}
    jclip, jnorm = jtrainer._clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 1.0)
    tg = tree.map(lambda a: torch.from_numpy(a.copy()), g_np)
    tclip, tnorm = ttrainer._clip_by_global_norm(tg, 1.0)
    assert tclip is tg  # in place
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ttrainer._global_norm(tg)), 1.0, rtol=1e-6)
    for g, e in zip(tree.leaves(tclip), jax.tree_util.tree_leaves(jclip)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6, atol=1e-6)
