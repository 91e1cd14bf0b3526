"""The port's all-to-all MoE dispatch (``models/moe.py::_moe_ffn_alltoall``)
against the JAX package's, and MoE on a training mesh.

On a 2 x 2 ("data", "model") mesh of 4 gloo ranks against the JAX function
under ``shard_map`` on 4 host devices, on the JAX test's inputs (4 experts,
d 16, F 32, top-2, [4, 8, 16] tokens, f32): each rank's output rows within
the JAX test's ``atol = 1e-4, rtol = 1e-3`` of JAX's (and of the replicated
dispatch at capacity factor 8, where nothing drops), the aux loss (the mean
over data shards) likewise; at capacity factor 1 each data shard drops by
its own token count, as in JAX.  The gradient through both all-to-alls
under the tensor-parallel mapping (x, the router, every expert leaf)
against ``jax.grad`` through the ``shard_map``, at rtol = atol = 1e-5.  On a
1 x 1 mesh the all-to-all dispatch is bit-equal to the replicated one,
forward (f32, bf16 and W8 experts) and backward (f32, bf16), and an MoE
arch's loss and gradients under the TP mapping with either dispatch are
bit-equal.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.launch import train as tlaunch  # noqa: E402
from test_torch_sharding import run_ranks  # noqa: E402

CAPACITY = (8.0, 1.0)
AUX_W = 0.5  # the aux loss's weight in the gradient tests
LEAVES = ("router", "wg", "wu", "wd")


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
        # the gradient of sum(out * cot) + AUX_W * aux through the shard_map,
        # on a mesh of Auto axes (the TP tests' mesh: jax.grad's scalars
        # take no Explicit one)
        from jax.sharding import AxisType
        auto = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        cot = jnp.asarray(rng.normal(size=(4, 8, 16)), jnp.float32)
        res["cot"] = np.asarray(cot)
        for cf in {CAPACITY!r}:
            def loss(x, p):
                out, aux = moe_ffn(x, p, top_k=2, capacity_factor=cf, dispatch="alltoall",
                                   mesh=auto)
                return jnp.sum(out * cot) + {AUX_W!r} * aux
            gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, params)
            res[f"gx_{{cf}}"] = np.asarray(gx)
            res.update({{f"g{{k}}_{{cf}}": np.asarray(v) for k, v in gp.items()}})
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


def test_alltoall_gradient_matches_jax_on_2x2(jax_moe, tmp_path):
    """The gradient of sum(out * cot) + AUX_W * aux through both all-to-alls,
    each rank's loss its share (its rows' term and the aux over the data
    shards).  Under the TP mapping the experts are its stored blocks of E
    over ``model`` and D over ``data``, and each expert leaf is gathered
    from the ranks' blocks; with no mapping every rank holds the full
    leaves and slices its experts, and the leaves' gradients are summed
    over the mesh.  Either way x's rows, the router's gradient summed over
    the data shards (the mesh step's rule for a replicated leaf) and every
    expert leaf against JAX's ``jax.grad`` through its ``shard_map``,
    float32, rtol = atol = 1e-5."""
    np.savez(tmp_path / "in.npz", **jax_moe)
    run_ranks(f"""
        import contextlib
        import numpy as np
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models.moe import moe_ffn

        inp = np.load(f"{{OUT}}/in.npz")
        mesh = make_test_mesh(2, 2, device="cpu")
        d, m = mesh.get_coordinate()
        rows = slice(2 * d, 2 * d + 2)
        n_data = sh.mesh_shape(mesh)["data"]
        res = {{}}
        for mapping in ("none", "tp"):
            for cf in {CAPACITY!r}:
                params = {{}}
                for k in {LEAVES!r}:
                    full = torch.from_numpy(inp[k])
                    if mapping == "tp":
                        full = sh.shard_local(full, sh.leaf_sharding(f"moe/{{k}}", full.shape,
                                                                     mesh))
                    params[k] = full.clone().requires_grad_() if mapping == "none" else \
                        full.requires_grad_()
                x = torch.from_numpy(inp["x"][rows]).requires_grad_()
                with sh.use_mesh(mesh) if mapping == "tp" else contextlib.nullcontext():
                    out, aux = moe_ffn(x, params, top_k=2, capacity_factor=cf,
                                       dispatch="alltoall", mesh=mesh)
                    loss = (out * torch.from_numpy(inp["cot"][rows])).sum() + \
                        {AUX_W!r} * aux / n_data
                    loss.backward()
                tag = f"{{mapping}}_{{cf}}"
                res[f"gx_{{tag}}"] = x.grad.numpy()
                g = params["router"].grad
                dist.all_reduce(g, group=mesh.get_group("data"))
                res[f"grouter_{{tag}}"] = g.numpy()
                for k in {LEAVES[1:]!r}:
                    g = params[k].grad
                    if mapping == "tp":
                        g = sh.gather(g, params[k]._mesh_sharding)
                    else:
                        dist.all_reduce(g)
                    res[f"g{{k}}_{{tag}}"] = g.numpy()
        np.savez(f"{{OUT}}/grad{{RANK}}.npz", **res)
        """, 4, tmp_path)
    for r in range(4):
        got = np.load(tmp_path / f"grad{r}.npz")
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        for mapping in ("none", "tp"):
            for cf in CAPACITY:
                tag, where = f"{mapping}_{cf}", f"{mapping}, cf {cf}, rank {r}"
                np.testing.assert_allclose(got[f"gx_{tag}"], jax_moe[f"gx_{cf}"][rows],
                                           rtol=1e-5, atol=1e-5, err_msg=f"x, {where}")
                for k in LEAVES:
                    np.testing.assert_allclose(got[f"g{k}_{tag}"], jax_moe[f"g{k}_{cf}"],
                                               rtol=1e-5, atol=1e-5, err_msg=f"{k}, {where}")
    assert np.abs(jax_moe["gwg_1.0"]).max() > 0.1  # the experts' gradient is not ~0


def test_alltoall_on_1x1_is_bit_equal_to_replicated(tmp_path):
    """Forward, f32, bf16 and W8 experts; backward (x, the router and every
    expert leaf) in f32 and bf16."""
    run_ranks("""
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import moe
        from repro_torch.models.transformer import quantize_params

        mesh = make_test_mesh(1, 1, device="cpu")
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, 24, 128, generator=gen)
        cot = torch.randn(2, 24, 128, generator=gen)
        for dtype, bits in ((torch.float32, 16), (torch.bfloat16, 16), (torch.float32, 8)):
            params = moe.init_moe_params(torch.Generator().manual_seed(1), 128, 256, 8, dtype)
            if bits < 16:
                params = quantize_params({"moe": params}, bits)["moe"]
            for cf in (1.25, 0.5):
                runs = []
                for kw in ({}, {"dispatch": "alltoall", "mesh": mesh}):
                    xs = x.to(dtype).clone().requires_grad_(bits == 16)
                    ps = {k: v.detach().clone().requires_grad_() for k, v in params.items()} \
                        if bits == 16 else params
                    out, aux = moe.moe_ffn(xs, ps, top_k=2, capacity_factor=cf, **kw)
                    runs.append([out, aux])
                    if bits == 16:
                        ((out.float() * cot).sum() + 0.5 * aux).backward()
                        runs[-1] += [xs.grad] + [ps[k].grad for k in sorted(ps)]
                a, b = runs
                assert len(a) == len(b) == (7 if bits == 16 else 2)
                assert all(torch.equal(u, v) for u, v in zip(a, b)), (dtype, bits, cf)
        """, 1, tmp_path)


_ARCH_1X1 = """
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import tree
    from repro_torch.train.trainer import mesh_value_and_grad

    mesh = make_test_mesh(1, 1, device="cpu")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1), 0,
                       device="cpu")
    runs = [mesh_value_and_grad(params, batch, dataclasses.replace(cfg, moe_dispatch=d), mesh)
            for d in ("replicated", "alltoall")]
    (la, ca, ga), (lb, cb, gb) = runs
    assert torch.equal(la, lb) and torch.equal(ca, cb), (la, lb)
    assert len(ga) == len(gb) == len(tree.leaves(params))
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))
    print("bit-equal", float(la))
"""


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_moe_arch_on_a_mesh_raises_naming_roadmap(arch, tmp_path):
    """An MoE arch trains on the launcher's mesh (the TP mapping), and there
    its all-to-all dispatch, which that mapping now takes, gives the
    replicated dispatch's loss and every gradient leaf bit for bit on a 1 x
    1 mesh (the all-to-alls are copies, the expert-split replicated branch
    the same products)."""
    import math

    report = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--mesh-data", "1",
                           "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert report["steps"] == 1 and math.isfinite(report["final_loss"])
    outs = run_ranks(_ARCH_1X1.replace("ARCH", repr(arch)), 1, tmp_path / "ranks")
    assert "bit-equal" in outs[0]
