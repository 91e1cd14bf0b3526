"""The port's ``CheckpointManager`` (``repro_torch/checkpoint/manager.py``):
round trips of bf16, int8, int32 and f32 leaves (bit for bit, each leaf back
on its target's device and dtype), async save and wait, keep-N, ``.tmp``
directories ignored and pruned, latest and missing; and the on-disk layout
shared with the JAX package's manager: a directory it wrote from JAX params
and an AdamW state restores in the port to the same arrays, leaf for leaf
(through ``params_from_numpy``'s tree), with the same digest, and one the
port wrote restores in JAX."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models.convert import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.optim import adamw, tree  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(8, 16, generator=g),
        "nested": {"b": torch.randint(0, 10, (4,), generator=g, dtype=torch.int32),
                   "q": torch.randint(-128, 128, (3, 5), generator=g, dtype=torch.int8)},
        "w": torch.randn(6, 4, generator=g).to(torch.bfloat16),
        "scalar": torch.tensor(3, dtype=torch.int32),
    }


def _assert_tree_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t, meta={"note": "x"})
    restored, manifest = mgr.restore(target=_tree(1))
    _assert_tree_equal(t, restored)
    assert manifest["step"] == 10 and manifest["meta"] == {"note": "x"}
    assert manifest["dtypes"] == ["float32", "int32", "int8", "int32", "bfloat16"]
    flat, _ = mgr.restore(10)
    assert [x.dtype for x in flat] == [x.dtype for x in tree.leaves(t)]


def test_restore_casts_to_the_target(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    target = tree.map(lambda x: x.double() if x.is_floating_point() else x, t)
    restored, _ = mgr.restore(1, target=target)
    assert restored["w"].dtype == torch.float64
    assert torch.equal(restored["w"], t["w"].double())


def test_async_save_snapshots_before_the_caller_moves_on(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(1)
    want = tree.map(torch.clone, t)
    mgr.save(5, t, blocking=False)
    t["a"].add_(1.0)  # the train step updates in place while the write runs
    mgr.wait()
    restored, _ = mgr.restore(5, target=t)
    _assert_tree_equal(want, restored)


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [3, 4]


def test_atomicity_ignores_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1))
    os.makedirs(tmp_path / "step_000000002.tmp")
    (tmp_path / "step_000000002.tmp" / "junk").write_text("x")
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(target=_tree(0))
    _assert_tree_equal(_tree(1), restored)
    mgr.save(3, _tree(3))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restore_latest_and_missing(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(7, _tree(7))
    mgr.save(9, _tree(9))
    restored, m = mgr.restore(target=_tree(0))
    assert m["step"] == 9
    _assert_tree_equal(_tree(9), restored)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(target={"a": torch.zeros(1)})


def _jax_state(tmp_path):
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), n_layers=2)
    params = jT.init_params(cfg, jax.random.PRNGKey(0))  # bf16 matrices, f32 norms
    init, _ = jadamw()
    return params, init(params)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    params, state = _jax_state(tmp_path)
    jm = JManager(str(tmp_path), keep=3)
    jm.save(4, (params, state))
    _, jman = jm.restore(4)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    target = (tree.map(torch.zeros_like, tparams), adamw().init(tparams))
    (rp, rs), man = CheckpointManager(str(tmp_path)).restore(4, target=target)
    assert man["digest"] == jman["digest"] and man["n_leaves"] == jman["n_leaves"]
    got = tree.leaves((rp, rs))
    exp = jax.tree_util.tree_leaves((params, state))
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        e = np.asarray(e)
        if e.dtype == jnp.bfloat16:
            e = e.view(np.uint16)
        np.testing.assert_array_equal(tensor_to_numpy(g), e)


def test_port_checkpoint_restores_in_jax(tmp_path):
    params, state = _jax_state(tmp_path)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    CheckpointManager(str(tmp_path)).save(2, (tparams, adamw().init(tparams)))
    restored, man = JManager(str(tmp_path)).restore(2, target=(params, state))
    for g, e in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves((params, state))):
        assert g.dtype == e.dtype and g.shape == e.shape
        assert np.asarray(g).tobytes() == np.asarray(e).tobytes()
