"""The port's all-to-all MoE dispatch (``models/moe.py::_moe_ffn_alltoall``)
against the JAX package's, and MoE on a training mesh.

On a 2 x 2 ("data", "model") mesh of 4 gloo ranks against the JAX function
under ``shard_map`` on 4 host devices, on the JAX test's inputs (4 experts,
d 16, F 32, top-2, [4, 8, 16] tokens, f32): each rank's output rows within
the JAX test's ``atol = 1e-4, rtol = 1e-3`` of JAX's (and of the replicated
dispatch at capacity factor 8, where nothing drops), the aux loss (the mean
over data shards) likewise; at capacity factor 1 each data shard drops by
its own token count, as in JAX.  On a 1 x 1 mesh the all-to-all dispatch is
bit-equal to the replicated one, f32, bf16 and W8 experts.  An MoE arch
trains on the launcher's mesh, which installs the tensor-parallel mapping;
what still raises there, naming ROADMAP, is the all-to-all dispatch, which
that mapping does not wire.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import train as tlaunch  # noqa: E402
from test_torch_sharding import run_ranks  # noqa: E402

CAPACITY = (8.0, 1.0)


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory, subproc):
    out = tmp_path_factory.mktemp("jax_moe") / "moe.npz"
    subproc(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.models.moe import init_moe_params, moe_ffn

        mesh = jax.make_mesh((2, 2), ("data", "model"))
        params = init_moe_params(jax.random.PRNGKey(0), 16, 32, 4, jnp.float32)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(4, 8, 16)), jnp.float32)
        res = {{k: np.asarray(v) for k, v in params.items()}}
        res["x"] = np.asarray(x)
        for cf in {CAPACITY!r}:
            ref, _ = moe_ffn(x, params, top_k=2, capacity_factor=cf)
            got, aux = moe_ffn(x, params, top_k=2, capacity_factor=cf, dispatch="alltoall",
                               mesh=mesh)
            res[f"ref_{{cf}}"], res[f"got_{{cf}}"] = np.asarray(ref), np.asarray(got)
            res[f"aux_{{cf}}"] = np.asarray(aux)
        np.savez({str(out)!r}, **res)
        """, n_devices=4)
    return dict(np.load(out))


def test_alltoall_matches_jax_on_2x2(jax_moe, tmp_path):
    np.savez(tmp_path / "in.npz", **jax_moe)
    run_ranks(f"""
        import numpy as np
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models.moe import moe_ffn

        inp = np.load(f"{{OUT}}/in.npz")
        params = {{k: torch.from_numpy(inp[k]) for k in ("router", "wg", "wu", "wd")}}
        mesh = make_test_mesh(2, 2, device="cpu")
        d, m = mesh.get_coordinate()
        # this rank's data shard; its experts' slice taken from the full leaves
        x = torch.from_numpy(inp["x"])[2 * d:2 * d + 2]
        res = {{}}
        for cf in {CAPACITY!r}:
            out, aux = moe_ffn(x, params, top_k=2, capacity_factor=cf, dispatch="alltoall",
                               mesh=mesh)
            res[f"out_{{cf}}"], res[f"aux_{{cf}}"] = out.numpy(), aux.numpy()
        np.savez(f"{{OUT}}/rank{{RANK}}.npz", **res)
        """, 4, tmp_path)
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        for cf in CAPACITY:
            np.testing.assert_allclose(got[f"out_{cf}"], jax_moe[f"got_{cf}"][rows],
                                       atol=1e-4, rtol=1e-3)
            np.testing.assert_allclose(got[f"aux_{cf}"], jax_moe[f"aux_{cf}"], atol=1e-6,
                                       rtol=1e-5)
        np.testing.assert_allclose(got["out_8.0"], jax_moe["ref_8.0"][rows], atol=1e-4,
                                   rtol=1e-3)
    # at capacity factor 1 the shards drop by their own token counts
    assert not np.allclose(jax_moe["got_1.0"], jax_moe["ref_1.0"], atol=1e-4)


def test_alltoall_on_1x1_is_bit_equal_to_replicated(tmp_path):
    run_ranks("""
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import moe
        from repro_torch.models.transformer import quantize_params

        mesh = make_test_mesh(1, 1, device="cpu")
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, 24, 128, generator=gen)
        for dtype, bits in ((torch.float32, 16), (torch.bfloat16, 16), (torch.float32, 8)):
            params = moe.init_moe_params(torch.Generator().manual_seed(1), 128, 256, 8, dtype)
            if bits < 16:
                params = quantize_params({"moe": params}, bits)["moe"]
            for cf in (1.25, 0.5):
                a = moe.moe_ffn(x.to(dtype), params, top_k=2, capacity_factor=cf)
                b = moe.moe_ffn(x.to(dtype), params, top_k=2, capacity_factor=cf,
                                dispatch="alltoall", mesh=mesh)
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (dtype, bits, cf)
        """, 1, tmp_path)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_moe_arch_on_a_mesh_raises_naming_roadmap(arch, tmp_path):
    import math

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    report = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--mesh-data", "1",
                           "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert report["steps"] == 1 and math.isfinite(report["final_loss"])
    cfg = get_config(arch).reduced()
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                                 cfg.n_experts, torch.float32)

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    with sh.use_mesh(Mesh()), pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.moe_ffn(torch.zeros(1, 4, cfg.d_model), params, top_k=cfg.top_k,
                    dispatch="alltoall")
