"""The port's GPipe-style ``pipeline_apply``
(``repro_torch/distributed/pipeline.py``) against the JAX package's, on the
JAX tests' inputs: 4 stages on 4 gloo ranks of a ("pod",) mesh against the
JAX function on 4 host devices to ``1e-5``, on every rank (the last stage's
outputs reach them all); and the one-stage degenerate case on a world of 1.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_sharding import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory, subproc):
    out = tmp_path_factory.mktemp("jax_pipe") / "pipe.npz"
    subproc(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline import pipeline_apply

        mesh = jax.make_mesh((4,), ("pod",))
        n_stages, n_micro, bm, d = 4, 8, 2, 16
        rng = np.random.default_rng(0)
        w = jnp.asarray(rng.normal(size=(n_stages, d, d)) * 0.3, jnp.float32)
        x = jnp.asarray(rng.normal(size=(n_micro, bm, d)), jnp.float32)
        got = pipeline_apply(lambda p, mb: jnp.tanh(mb @ p), w, x, mesh, axis="pod")
        np.savez({str(out)!r}, w=np.asarray(w), x=np.asarray(x), got=np.asarray(got))
        """, n_devices=4)
    return dict(np.load(out))


_STAGES = """
    import numpy as np
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    inp = np.load(f"{OUT}/in.npz")
    w, x = torch.from_numpy(inp["w"]), torch.from_numpy(inp["x"])
    mesh = make_mesh((WORLD,), ("pod",), device="cpu")
    got = pipeline_apply(lambda p, mb: torch.tanh(mb @ p), w, x, mesh, axis="pod")
    np.save(f"{OUT}/rank{RANK}.npy", got.numpy())
"""


def test_pipeline_matches_jax(jax_pipeline, tmp_path):
    np.savez(tmp_path / "in.npz", w=jax_pipeline["w"], x=jax_pipeline["x"])
    run_ranks(_STAGES, 4, tmp_path)
    w, x = jax_pipeline["w"], jax_pipeline["x"]
    ref = x
    for s in range(4):
        ref = np.tanh(ref @ w[s])
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npy")
        np.testing.assert_allclose(got, jax_pipeline["got"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_pipeline_single_stage_degenerate(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(1, 4, 4)).astype(np.float32)
    x = rng.normal(size=(3, 2, 4)).astype(np.float32)
    np.savez(tmp_path / "in.npz", w=w, x=x)
    run_ranks(_STAGES, 1, tmp_path)
    np.testing.assert_allclose(np.load(tmp_path / "rank0.npy"), np.tanh(x @ w[0]), atol=1e-6)
