"""The port's int8 compressed gradient reduction
(``repro_torch/distributed/collectives.py``) against the JAX package's.

``_quantize_chunks`` / ``_dequantize_chunks`` bit-exact in one process;
then ``compressed_psum_mean`` on 8 and on 4 gloo ranks against the JAX
function under ``shard_map`` on as many host devices (op by op, as the
JAX tests run it: under ``jax.jit`` XLA fuses the divisions and the peer
sum, and a quarter of the mean's elements move by an ulp), on the JAX
tests' inputs: every rank's first-stage int8 payload and scales, its mean and its
two residuals bit for bit, the mean within the JAX test's bound of the
exact mean; the JAX error-feedback test's 6 rounds (the cumulative error
does not grow); and ``compressed_grad_reduce`` over a tree with a leaf under
one chunk (reduced exactly) against the JAX function.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.distributed import collectives as jcol  # noqa: E402
from repro_torch.distributed import collectives as tcol  # noqa: E402
from test_torch_sharding import run_ranks  # noqa: E402


@pytest.mark.parametrize("n,n_shards", [(4096, 4), (5000, 8), (1000, 3)])
def test_chunk_quantize_matches_jax(n, n_shards):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * 10).astype(np.float32)
    x[:7] = [0.5, -0.5, 1.5, 2.5, 0, -0.0, 3e-39]  # rounding ties, zeros, a subnormal
    q, s = tcol._quantize_chunks(torch.from_numpy(x), n_shards)
    jq, js = jcol._quantize_chunks(jnp.asarray(x), n_shards)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tcol._dequantize_chunks(q, s, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(jcol._dequantize_chunks(jq, js, n)))
    bound = np.repeat(s.numpy().reshape(-1), tcol._CHUNK)[:n] / 2 + 1e-6
    assert (np.abs(back - x) <= bound).all()


def test_wire_bytes_are_quarter_fp32():
    q, s = tcol._quantize_chunks(torch.zeros(1 << 16), n_shards=8)
    assert q.numel() + 4 * s.numel() < 0.3 * (1 << 16) * 4


@pytest.fixture(scope="module")
def jax_reductions(tmp_path_factory, subproc):
    out = tmp_path_factory.mktemp("jax_col")
    subproc(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.distributed.collectives import (compressed_grad_reduce,
                                                   compressed_psum_mean, init_error_state)

        res = {{}}
        for n_dev, seed, cols, scale in ((8, 0, 4096, 5.0), (4, 1, 2048, 1.0)):
            mesh = jax.make_mesh((n_dev,), ("data",), devices=jax.devices()[:n_dev])
            rng = np.random.default_rng(seed)
            g_all = jnp.asarray(rng.normal(size=(n_dev, cols)) * scale, jnp.float32)
            per = -(-cols // n_dev); per += (-per) % 1024

            def local(g_shard):
                g = g_shard[0]
                red = compressed_psum_mean(g, "data")
                exact = jax.lax.pmean(g, "data")
                e, e2 = jnp.zeros_like(g), jnp.zeros((per // 1024, 1024), jnp.float32)
                reds, e1s, e2s = [], [], []
                for _ in range(6 if n_dev == 4 else 1):
                    r, e, e2 = compressed_psum_mean(g + e, "data", e2)
                    reds.append(r); e1s.append(e); e2s.append(e2)
                return (red[None], exact[None], jnp.stack(reds)[None], jnp.stack(e1s)[None],
                        jnp.stack(e2s)[None])

            spec = P("data")
            # op by op, as the JAX tests run it (under jit XLA fuses the
            # divisions and sums, and the mean moves by an ulp)
            outs = shard_map(local, mesh=mesh, in_specs=P("data", None),
                             out_specs=(spec,) * 5, check_rep=False)(g_all)
            for k, v in zip(("red", "exact", "reds", "e1s", "e2s"), outs):
                res[f"{{n_dev}}_{{k}}"] = np.asarray(v)
            res[f"{{n_dev}}_g"] = np.asarray(g_all)

        # compressed_grad_reduce: the same tree on every shard (replicated grads)
        mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4])
        rng = np.random.default_rng(2)
        grads = {{"big": jnp.asarray(rng.normal(size=(48, 100)), jnp.float32),
                  "tiny": jnp.asarray(rng.normal(size=(7, 9)), jnp.float32)}}
        err = init_error_state(grads, 4)
        red, new = compressed_grad_reduce(grads, err, mesh)
        red2, new2 = compressed_grad_reduce(grads, new, mesh)
        for name in ("big", "tiny"):
            res["tree_g_" + name] = np.asarray(grads[name])
            res["tree_red_" + name] = np.asarray(red[name])
            res["tree_red2_" + name] = np.asarray(red2[name])
            res["tree_e1_" + name] = np.asarray(new2[name]["e1"])
            res["tree_e2_" + name] = np.asarray(new2[name]["e2"])
        np.savez({str(out / "jax.npz")!r}, **res)
        """, n_devices=8)
    return dict(np.load(out / "jax.npz"))


def _port_run(world: int, tmp_path, jax_npz: dict) -> list[dict]:
    np.savez(tmp_path / "in.npz", g=jax_npz[f"{world}_g"],
             **{k: v for k, v in jax_npz.items() if k.startswith("tree_g_")})
    run_ranks("""
        import numpy as np
        from repro_torch.distributed import collectives as col

        inp = np.load(f"{OUT}/in.npz")
        g = torch.from_numpy(inp["g"][RANK])
        q, s = col._quantize_chunks(g, WORLD)
        red = col.compressed_psum_mean(g, None)
        per = -(-g.numel() // WORLD); per += (-per) % 1024
        e, e2 = torch.zeros_like(g), torch.zeros(per // 1024, 1024)
        reds, e1s, e2s = [], [], []
        for _ in range(6 if WORLD == 4 else 1):
            r, e, e2 = col.compressed_psum_mean(g + e, None, e2)
            reds.append(r); e1s.append(e); e2s.append(e2)
        res = dict(q=q.numpy(), s=s.numpy(), red=red.numpy(), reds=torch.stack(reds).numpy(),
                   e1s=torch.stack(e1s).numpy(), e2s=torch.stack(e2s).numpy())
        if WORLD == 4:
            class OneAxis:  # the ("data",) mesh: its group is the whole world
                def get_group(self, axis):
                    return dist.group.WORLD
            grads = {k: torch.from_numpy(inp["tree_g_" + k]) for k in ("big", "tiny")}
            err = col.init_error_state(grads, 4)
            red1, new = col.compressed_grad_reduce(grads, err, OneAxis())
            red2, new2 = col.compressed_grad_reduce(grads, new, OneAxis())
            for k in grads:
                res["tree_red_" + k] = red1[k].numpy()
                res["tree_red2_" + k] = red2[k].numpy()
                res["tree_e1_" + k] = new2[k]["e1"].numpy()
                res["tree_e2_" + k] = new2[k]["e2"].numpy()
        np.savez(f"{OUT}/rank{RANK}.npz", **res)
        """, world, tmp_path)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [8, 4])
def test_compressed_psum_mean_matches_jax(world, jax_reductions, tmp_path):
    exp = jax_reductions
    ranks = _port_run(world, tmp_path, exp)
    for r, got in enumerate(ranks):
        jq, js = jcol._quantize_chunks(jnp.asarray(exp[f"{world}_g"][r]), world)
        np.testing.assert_array_equal(got["q"], np.asarray(jq))  # first-stage payload
        np.testing.assert_array_equal(got["s"], np.asarray(js))  # and its scales
        for k in ("red", "reds", "e1s", "e2s"):
            np.testing.assert_array_equal(got[k], exp[f"{world}_{k}"][r], err_msg=f"{k} {r}")
    red, exact = np.stack([g["red"] for g in ranks]), exp[f"{world}_exact"]
    assert np.abs(red - red[0]).max() == 0  # every rank holds the same mean
    assert np.abs(red - exact).max() < 0.05 * np.abs(exact).max()
    if world == 4:
        # error feedback: the cumulative sum telescopes (the JAX test's rule)
        acc = np.cumsum(ranks[0]["reds"], axis=0)
        errs = np.abs(acc - np.arange(1, 7)[:, None] * exact[0]).max(axis=1)
        assert errs[-1] < 2.0 * errs[0] + 1e-4, errs
        for got in ranks:
            for k in ("big", "tiny"):
                for f in ("red", "red2", "e1", "e2"):
                    np.testing.assert_array_equal(got[f"tree_{f}_{k}"], exp[f"tree_{f}_{k}"],
                                                  err_msg=f"{f} {k}")
        np.testing.assert_allclose(ranks[0]["tree_red_tiny"], exp["tree_g_tiny"], rtol=1e-6)
