"""The port's sharding rules (``repro_torch/distributed/sharding.py``) against
the JAX package's (``repro/distributed/sharding.py``).

The rule functions (``param_spec``, ``validate_spec``, the E=3 fallback)
against the JAX functions on the same paths and meshes; then, for every
leaf of reduced yi-9b, kimi-k2-1t-a32b, zamba2-7b and mamba2-130m on a
2 x 2 ("data", "model") mesh, the block each of 4 gloo ranks holds against
the index JAX gives the device at the same mesh position
(``NamedSharding.devices_indices_map``), the same block as DTensor cuts it
(``distribute_tensor`` with ``NamedSharding.placements``), the full leaf
gathered back from the blocks (``sharding.gather``, ``gather_weight``), and
the gather's backward summing the ranks' gradients into each block.

``run_ranks`` (used by the other multi-rank test files) starts one Python
process per rank; they join a gloo group at a ``file://`` store under the
test's ``tmp_path``, each with its own timeout.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("yi-9b", "kimi-k2-1t-a32b", "zamba2-7b", "mamba2-130m")

_PRELUDE = """
import datetime, sys
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + sys.argv[4], rank=RANK,
                        world_size=WORLD, timeout=datetime.timedelta(seconds=90))
"""


def run_ranks(code: str, world: int, out_dir, timeout: float = 180) -> list[str]:
    """Runs ``code`` in ``world`` processes of one gloo group -> their
    outputs.  In ``code``: RANK, WORLD, OUT (``out_dir``, for results)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "gloo_store"
    store.unlink(missing_ok=True)  # a store left by an earlier group would hang this one
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    src = _PRELUDE + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), str(world), str(out_dir),
                               str(store)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(o[-3000:] for o in outs)
    return outs


def _jspec(spec) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in spec]


@pytest.mark.parametrize("path,ndim", [
    ("embed", 2), ("unembed", 2), ("blocks/wq", 3), ("blocks/wo", 3), ("blocks/moe/wg", 4),
    ("blocks/mlp/wd", 3), ("blocks/norm1", 2), ("final_norm", 1), ("blocks/in_proj", 3),
    ("blocks/A_log", 2), ("blocks/router", 3), ("m/blocks/wk", 3), ("mystery", 2)])
def test_param_spec_rules_match_jax(path, ndim):
    got, exp = tsh.param_spec(path, ndim), jsh.param_spec(path, ndim)
    assert list(got) == list(exp), (got, exp)
    assert got == tsh.P(*exp)


class _JMesh:
    """What the rule functions of both packages read of a mesh, without
    devices."""

    def __init__(self, names, sizes):
        self.axis_names, self.shape = tuple(names), dict(zip(names, sizes))


MESH22 = (("data", "model"), (2, 2))


@pytest.mark.parametrize("shape,want", [
    ((56, 8, 6144, 16384), ("model", "data")),  # E=8 divisible -> experts sharded
    ((56, 3, 6144, 16384), ("data", "model")),  # E=3 -> the fallback candidate
])
def test_param_spec_fallback_candidates_match_jax(shape, want):
    got = tsh.param_spec("blocks/moe/wg", 4, shape, _JMesh(*MESH22))
    exp = jsh.param_spec("blocks/moe/wg", 4, shape, _JMesh(*MESH22))
    assert list(got) == list(exp)
    assert tuple(a for a in got if a) == want


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (7, 8)), ((("data", "model"), None), (8, 3)),
    ((("data", "model"), None), (6, 3)), (("pod", "model"), (4, 4)),
    ((("pod", "data"), "model"), (4, 6))])
def test_validate_spec_matches_jax(spec, shape):
    got = tsh.validate_spec(tsh.P(*spec), shape, _JMesh(*MESH22))
    exp = jsh.validate_spec(JP(*spec), shape, _JMesh(*MESH22))
    assert _jspec(got) == _jspec(exp), (got, exp)


def test_spec_out_of_mesh_order_has_no_placements():
    mesh = _JMesh(*MESH22)
    ok = tsh.NamedSharding(mesh, tsh.P(("data", "model"), None))
    assert [str(p) for p in ok.placements(2)] == ["S(0)", "S(0)"]
    # model-major on one dim: DTensor would split data-major
    with pytest.raises(ValueError, match="order"):
        tsh.NamedSharding(mesh, tsh.P(("model", "data"), None)).placements(2)
    # the blocks themselves follow the spec's order
    mm = tsh.NamedSharding(mesh, tsh.P(("model", "data"), None))
    assert mm.index((8, 3), (1, 0))[0] == slice(2, 4)  # model 0, data 1 -> block 1
    assert ok.index((8, 3), (1, 0))[0] == slice(4, 6)  # data 1, model 0 -> block 2


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory, subproc):
    """{arch: {path: {"spec", "shape", "index": per mesh position [[start,
    stop] per dim]}}} from JAX's shardings on a 2 x 2 mesh of 4 host
    devices."""
    out = tmp_path_factory.mktemp("jax_blocks") / "blocks.json"
    subproc(f"""
        import json
        from functools import partial
        import jax
        from repro.configs import get_config
        from repro.distributed.sharding import tree_shardings
        from repro.models import transformer as T

        mesh = jax.make_mesh((2, 2), ("data", "model"))
        res = {{}}
        for name in {ARCHS!r}:
            cfg = get_config(name).reduced()
            shapes = jax.eval_shape(partial(T.init_params, cfg), jax.random.PRNGKey(0))
            sh = tree_shardings(shapes, mesh)
            flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
            flat_sh = jax.tree_util.tree_leaves(sh)
            arch = {{}}
            for (kp, leaf), s in zip(flat, flat_sh):
                path = "/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in kp)
                imap = s.devices_indices_map(leaf.shape)
                idx = [[[sl.start or 0, leaf.shape[d] if sl.stop is None else sl.stop]
                        for d, sl in enumerate(imap[dev])] for dev in mesh.devices.flat]
                arch[path] = {{"spec": [list(a) if isinstance(a, tuple) else a
                                       for a in s.spec],
                              "shape": list(leaf.shape), "index": idx}}
            res[name] = arch
        json.dump(res, open({str(out)!r}, "w"))
        """, n_devices=4)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_blocks(tmp_path_factory):
    """The same from the port, each of 4 gloo ranks reporting its own
    blocks, after checking them against DTensor's and gathering them."""
    out = tmp_path_factory.mktemp("port_blocks")
    run_ranks(f"""
        import json
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import transformer as T

        mesh = make_test_mesh(2, 2, device="cpu")
        res = {{}}
        for name in {ARCHS!r}:
            params = T.init_params(get_config(name).reduced(),
                                   torch.Generator().manual_seed(0))
            shard_tree = sh.tree_shardings(params, mesh)
            arch = {{}}
            flat, by_path = [], {{}}
            sh._map_with_path(lambda p, leaf: flat.append((p, leaf)), params)
            sh._map_with_path(lambda p, s: by_path.__setitem__(p, s), shard_tree)
            for path, leaf in flat:
                s = by_path[path]
                idx = s.index(tuple(leaf.shape))
                block = sh.shard_local(leaf, s)
                assert torch.equal(block, leaf[idx]), path
                dt = distribute_tensor(leaf, mesh, s.placements(leaf.ndim)).to_local()
                assert torch.equal(dt, block), path
                full = sh.gather(block, s)
                assert torch.equal(full, leaf), path
                with sh.use_mesh(mesh, data_only=True):
                    assert torch.equal(sh.gather_weight(block), leaf), path
                    assert sh.gather_weight(leaf) is leaf
                    if sh.moves(s) and leaf.is_floating_point():
                        # the gather's backward sums the ranks' gradients
                        b = block.detach().requires_grad_(True)
                        b._mesh_sharding = s
                        (sh.gather_weight(b).float().sum() * (RANK + 1)).backward()
                        assert torch.equal(b.grad.float(), torch.full(b.shape, 10.0)), path
                arch[path] = {{"spec": [list(a) if isinstance(a, tuple) else a
                                       for a in s.spec],
                              "shape": list(leaf.shape),
                              "index": [[i.start, i.stop] for i in idx]}}
            res[name] = arch
        json.dump(res, open(f"{{OUT}}/rank{{RANK}}.json", "w"))
        """, 4, out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_local_blocks_match_jax_device_shards(arch, jax_blocks, port_blocks):
    exp = jax_blocks[arch]
    assert set(port_blocks[0][arch]) == set(exp)
    sharded = 0
    for path, e in exp.items():
        for rank in range(4):  # rank r sits at the mesh position of device r
            got = port_blocks[rank][arch][path]
            assert got["shape"] == e["shape"] and got["spec"] == e["spec"], (path, got, e)
            assert got["index"] == e["index"][rank], (path, rank, got, e)
        sharded += any(a is not None for a in e["spec"])
    assert sharded >= 4  # the big 2-D weights are sharded
    assert "model" in str(exp["embed"]["spec"])
