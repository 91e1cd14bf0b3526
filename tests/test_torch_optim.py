"""The port's optimizers and LR schedule (``repro_torch/optim``) against the
JAX package's, on the same f32 params and gradients drawn with numpy seeds.

Tolerances: ``adamw`` and ``adafactor`` states and updates within ``rtol =
atol = 1e-6`` of JAX's over three steps (the two frameworks' ``pow``,
``sqrt`` and means may round a last bit apart); ``adamw8bit``'s int8 codes
equal JAX's except where the f32 moment lands a last bit apart on the other
side of a rounding boundary: then the code differs by one, in at most 1 of
1000 codes, and the block scales within 1e-6; ``cosine_schedule`` within 1
ulp.  The in-place ``apply`` (the trainer's) equals the pure ``update``
bit for bit.  Then the JAX tests' own properties, on the port: the loss of
a quadratic falls under each optimizer, 8-bit tracks f32, the state memory
regimes and adafactor's factored shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import adamw8bit as jadamw8bit  # noqa: E402
from repro.optim.schedules import cosine_schedule as jcosine  # noqa: E402
from repro_torch.models.convert import opt_state_to_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim import adafactor, adamw, adamw8bit, cosine_schedule, tree  # noqa: E402

SHAPES = {"w": (16, 40), "b": (40,), "stack": {"wq": (3, 24, 20), "norm": (3, 24)}}
TOL = dict(rtol=1e-6, atol=1e-6)


def _draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _to_torch(tree_np):
    return tree.map(lambda a: torch.from_numpy(np.array(a)), tree_np)


def _close(got, exp, tol=TOL):
    ga, ea = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(exp)
    assert len(ga) == len(ea)
    for g, e in zip(ga, ea):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e), **tol)


def _run_both(jmake, tmake, steps=3, lr=0.05, seed=0):
    """Three steps of the same grads through both packages -> per step the
    (updates, states) of each, as numpy trees."""
    rng = np.random.default_rng(seed)
    p_np = _draw(rng, SHAPES)
    ji, ju = jmake()
    opt = tmake()
    jp, jst = jax.tree.map(jnp.asarray, p_np), None
    tp, tst = _to_torch(p_np), None
    jst, tst = ji(jp), opt.init(tp)
    out = []
    for _ in range(steps):
        g_np = _draw(rng, SHAPES, 0.3)
        jupd, jst = ju(jax.tree.map(jnp.asarray, g_np), jst, jp, lr)
        tupd, tst = opt.update(_to_torch(g_np), tst, tp, torch.tensor(lr))
        jp = jax.tree.map(lambda p, u: p + u, jp, jupd)
        tp = tree.map(lambda p, u: p + u, tp, tupd)
        out.append(((jupd, jst), (params_to_numpy(tupd), opt_state_to_numpy(tst))))
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_states_and_updates_match_jax(name):
    jmake, tmake = {"adamw": (jadamw, adamw), "adafactor": (jadafactor, adafactor)}[name]
    for (jupd, jst), (tupd, (tstep, tinner)) in _run_both(jmake, tmake):
        _close(tupd, jupd)
        assert int(tstep) == int(jst.step)
        _close(tinner, jst.inner)
    if name == "adafactor":  # factored r / c on the matrices, v on the vectors
        assert set(tinner["w"]) == {"r", "c"} and set(tinner["b"]) == {"v"}
        assert tinner["stack"]["wq"]["c"].shape == (3, 20)


def test_adamw8bit_codes_match_jax():
    n_codes = n_off = 0
    for (jupd, jst), (tupd, (tstep, tinner)) in _run_both(jadamw8bit, adamw8bit):
        _close(tupd, jupd)
        jinner = jax.tree.map(np.asarray, jst.inner)
        for moment in ("m", "v"):
            jl = jax.tree_util.tree_leaves(jinner[moment])
            tl = jax.tree_util.tree_leaves(tinner[moment])
            for t, j in zip(tl, jl):  # q (int8 codes) and s (block scales), in key order
                if t.dtype == np.int8:
                    diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
                    assert diff.max() <= 1
                    n_codes += diff.size
                    n_off += int((diff > 0).sum())
                else:
                    np.testing.assert_allclose(t, j, **TOL)
    assert n_off <= n_codes // 1000, (n_off, n_codes)


@pytest.mark.parametrize("make", [adamw, adamw8bit, adafactor])
def test_apply_in_place_equals_update(make):
    """The trainer's in-place ``apply`` gives the pure ``update``'s params and
    state bit for bit, on bf16 and f32 leaves, and writes into the same
    tensors."""
    rng = np.random.default_rng(3)
    p_np = _draw(rng, SHAPES)
    opt = make()
    pure = tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p_np)
    pure["b"] = pure["b"].float()
    inplace = tree.map(torch.clone, pure)
    st_pure, st_in = opt.init(pure), opt.init(inplace)
    storage = [t.data_ptr() for t in tree.leaves((inplace, st_in.inner))]
    for step in range(3):
        grads = tree.map(lambda a, p: torch.from_numpy(a).to(p.dtype),
                         _draw(rng, SHAPES, 0.3), pure)
        lr = torch.tensor(0.01 * (step + 1))
        upd, st_pure = opt.update(grads, st_pure, pure, lr)
        pure = tree.map(lambda p, u: p + u, pure, upd)
        st_in = opt.apply(grads, st_in, inplace, lr)
    for a, b in zip(tree.leaves((pure, st_pure)), tree.leaves((inplace, st_in))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [t.data_ptr() for t in tree.leaves((inplace, st_in.inner))] == storage


def test_cosine_schedule_within_one_ulp():
    for base, warm, total in ((3e-4, 100, 1000), (3e-3, 5, 30), (1e-2, 1, 6), (0.1, 0, 10)):
        jlr, tlr = jcosine(base, warm, total), cosine_schedule(base, warm, total)
        steps = sorted({0, 1, warm - 1, warm, warm + 1, total // 2, total - 1, total, total + 5})
        for s in (x for x in steps if x >= 0):
            exp = np.float32(jlr(jnp.asarray(s, jnp.int32)))
            got = tlr(s)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert abs(float(got) - float(exp)) <= float(np.spacing(np.abs(exp))), (s, got, exp)


# ------------------------------------------- the JAX tests' own properties
def _quadratic_problem(seed=0, d=64):
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32))
    params = {"w": torch.zeros(d, d), "b": torch.zeros(d)}

    def grads(p):
        leaves = tree.leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        g = torch.autograd.grad(loss(p), leaves)
        for x in leaves:
            x.requires_grad_(False)
        return tree.unflatten(p, list(g))

    def loss(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean((p["b"] - 1.0) ** 2)

    return params, loss, grads


@pytest.mark.parametrize("make", [adamw, adamw8bit, adafactor])
def test_loss_decreases(make):
    params, loss, grads = _quadratic_problem()
    opt = make()
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(60):
        state = opt.apply(grads(params), state, params, 0.05)
    assert float(loss(params)) < 0.2 * l0


def test_adamw8bit_tracks_adamw():
    p8, loss, grads = _quadratic_problem(seed=1)
    p32 = tree.map(torch.clone, p8)
    o8, o32 = adamw8bit(wd=0.0), adamw(wd=0.0)
    s8, s32 = o8.init(p8), o32.init(p32)
    l0 = float(loss(p8))
    for _ in range(30):
        s8 = o8.apply(grads(p8), s8, p8, 0.05)
        s32 = o32.apply(grads(p32), s32, p32, 0.05)
    assert float(torch.max(torch.abs(p8["w"] - p32["w"]))) < 0.15
    assert float(loss(p8)) < 0.5 * l0


def test_state_memory_regimes():
    params = {"w": torch.zeros(256, 512)}

    def state_bytes(opt):
        return sum(t.numel() * t.element_size() for t in tree.leaves(opt.init(params)))

    n = 256 * 512
    b_adam, b_8bit, b_fact = (state_bytes(o()) for o in (adamw, adamw8bit, adafactor))
    assert b_adam >= 8 * n
    assert b_8bit < 0.35 * b_adam
    assert b_fact < 0.02 * b_adam
