"""Elastic restore (``repro_torch/distributed/elastic.py``,
``checkpoint/manager.py::restore(shardings=)``) against the JAX package.

4 gloo ranks: a reduced llama3.2-3b's params and adamw state (and the JAX
test's 8 x 8 ``x``) are placed on a (4, 1) ("data", "model") mesh
(``reshard_state``), gathered and saved host-gathered by rank 0, then
restored onto a (2, 2) mesh (``make_elastic_mesh(4, 2)``) with
``shardings=``: every rank's block equals the saved leaf cut at its mesh
position.  The JAX package restores the same directory onto a (2, 2) mesh
of 4 host devices, and each device's shard equals the port's block at its
position.  ``make_elastic_mesh`` refuses a model-parallel degree that does
not divide, and leaves ranks past ``n_devices`` out of the mesh.
"""
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_sharding import run_ranks  # noqa: E402


def test_save_on_4x1_restores_onto_2x2_like_jax(tmp_path, subproc):
    ckpt = tmp_path / "ckpt"
    run_ranks(f"""
        import json
        import numpy as np
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as sh
        from repro_torch.distributed.elastic import make_elastic_mesh, reshard_state
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw, tree

        try:
            make_elastic_mesh(4, 3, device="cpu")
            raise AssertionError("model_parallel 3 accepted on 4 devices")
        except ValueError:
            pass
        part = make_elastic_mesh(3, 1, device="cpu")  # rank 3 left out
        assert (part.get_coordinate() is None) == (RANK == 3)

        cfg = get_config("llama3.2-3b").reduced()
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        params["x"] = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        state = (params, adamw().init(params))
        mesh1 = make_elastic_mesh(4, 1, device="cpu")
        local = reshard_state(state, mesh1)
        full = tree.map(lambda t: sh.gather(t, t._mesh_sharding), local)
        for a, b in zip(tree.leaves(full), tree.leaves(state)):
            assert torch.equal(a, b)
        mgr = CheckpointManager({str(ckpt)!r})
        if RANK == 0:
            mgr.save(1, full)
        dist.barrier()

        mesh2 = make_elastic_mesh(4, 2, device="cpu")
        shardings = sh.tree_shardings(state, mesh2)
        shardings[0]["x"] = sh.NamedSharding(mesh2, sh.P("data", "model"))  # the JAX test's
        restored, _ = mgr.restore(target=state, shardings=shardings)
        blocks = {{}}
        for i, (got, want, s) in enumerate(zip(tree.leaves(restored), tree.leaves(state),
                                                tree.leaves(shardings))):
            idx = s.index(tuple(want.shape))
            assert got.dtype == want.dtype and torch.equal(got, want[idx]), i
            blocks[i] = [[x.start, x.stop] for x in idx]
        assert restored[0]["x"].shape == (4, 4)  # ("data", "model") on 8 x 8
        json.dump(blocks, open(f"{{OUT}}/rank{{RANK}}.json", "w"))
        """, 4, tmp_path)
    out = tmp_path / "jax.json"
    subproc(f"""
        import json
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.checkpoint import CheckpointManager
        from repro.configs import get_config
        from repro.distributed.sharding import tree_shardings
        from repro.models import transformer as T
        from repro.optim import adamw

        cfg = get_config("llama3.2-3b").reduced()
        params = T.init_params(cfg, jax.random.PRNGKey(0))
        params["x"] = jax.numpy.arange(64, dtype=jax.numpy.float32).reshape(8, 8)
        opt_init, _ = adamw()
        target = (params, opt_init(params))
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        shardings = tree_shardings(target, mesh)
        shardings[0]["x"] = NamedSharding(mesh, P("data", "model"))
        restored, _ = CheckpointManager({str(ckpt)!r}).restore(target=target,
                                                                shardings=shardings)
        res = {{}}
        for i, leaf in enumerate(jax.tree_util.tree_leaves(restored)):
            by_dev = {{s.device: s for s in leaf.addressable_shards}}
            res[i] = [[[[sl.start or 0, leaf.shape[d] if sl.stop is None else sl.stop]
                        for d, sl in enumerate(by_dev[dev].index)],
                       np.asarray(by_dev[dev].data).astype(np.float64).ravel()[:8].tolist()]
                      for dev in mesh.devices.flat]
        json.dump(res, open({str(out)!r}, "w"))
        """, n_devices=4)
    jax_res = json.loads(out.read_text())
    full = [np.load(ckpt / "step_000000001" / f"arr_{int(i):05d}.npy") for i in sorted(
        jax_res, key=int)]
    for r in range(4):
        port = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(port) == len(jax_res)
        for i, per_dev in jax_res.items():
            index, head = per_dev[r]
            assert port[i] == index, (i, r)
            if full[int(i)].dtype.kind == "f":
                block = full[int(i)][tuple(slice(a, b) for a, b in index)]
                np.testing.assert_array_equal(block.astype(np.float64).ravel()[:8], head)
