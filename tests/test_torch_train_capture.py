"""The captured train step (``repro_torch/train/trainer.py``: ``Trainer`` runs
every step of a run without a mesh through ``serve/graphs.py``'s
``StepGraphs``, over static input buffers) on the CPU, where the same
function runs eagerly; its CUDA-graph side is ``tests/test_torch_cuda.py``'s
(``-k "captured_trainer or restore_into or lr_on_the_card"``).

(a) The lr computed from a step tensor (the captured step's) against
    ``repro.optim.schedules.cosine_schedule`` at every step from 0 to
    ``total + 2``: bit-equal wherever XLA's float32 cosine is correctly
    rounded; at the few steps where it is not, the test names them and
    holds the port to the reference's arithmetic on the correctly rounded
    cosine (the port rounds the float64 cosine once, on either device).
    And bit-equal to the port's own Python-step lr everywhere.
(b) The function the graph captures, traced on meta tensors (the dry run's
    shape-only params and batch) under a dispatch mode that fails on any
    read of a value back to the host (``_local_scalar_dense``, ``nonzero``)
    and on any tensor that is not meta (a CPU constant baked into the
    graph, as the old CPU lr would be), for reduced llama3.2-3b, mamba2-130m
    and mixtral-8x22b under adamw, and llama under adamw8bit and adafactor.
(c) Three ``Trainer`` steps (adafactor) through the static buffers against
    JAX's jitted ``Trainer`` (one JAX run for the module) at
    ``tests/test_torch_train.py``'s tolerance (float32), and bit-equal to the port's eager
    ``make_train_step`` with Python steps (bf16).
(d) ``run_with_restarts`` with a failure injected: the restart writes the
    checkpoint into the first attempt's tensors and ends bit-equal to an
    uninterrupted run (bf16).

The bit-equal checks run in bf16: on the CPU the float32 embedding
gradient (an indexed accumulation over threads) is not the same bits from
one run to the next, in the eager step as in this one; the card's trainer
runs deterministic kernels.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim.schedules import cosine_schedule as jcosine  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_specs, make_batch  # noqa: E402
from repro_torch.distributed import run_with_restarts  # noqa: E402
from repro_torch.launch.dryrun import meta_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.optim import tree  # noqa: E402
from repro_torch.optim.schedules import cosine_schedule  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, make_train_step  # noqa: E402
from repro_torch.train.trainer import capturable_step  # noqa: E402
from test_torch_train import TOL, _arch  # noqa: E402

KW = dict(lr=3e-3, warmup=1, total_steps=10, grad_clip=1.0)
DATA = dict(vocab=256, seq_len=64, global_batch=8, seed=2)
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these runs are many small ops, which a host
    whose cores are busy slows most when each op fans out over threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ (a) the lr
@pytest.mark.parametrize("base,warm,total", [(3e-4, 100, 1000), (6e-4, 30, 300),
                                             (3e-3, 5, 30), (0.1, 0, 10)])
def test_lr_from_a_step_tensor_is_jaxs(base, warm, total):
    jlr, tlr = jcosine(base, warm, total), cosine_schedule(base, warm, total)
    steps = np.arange(total + 3)
    exp = np.array([np.float32(jlr(jnp.asarray(s, jnp.int32))) for s in steps])
    got = torch.stack([tlr(s) for s in torch.arange(total + 3, dtype=torch.int32)])
    assert got.dtype == torch.float32 and got.ndim == 1
    assert torch.equal(got, torch.stack([tlr(int(s)) for s in steps]))
    got = got.numpy()
    # the steps where XLA's float32 cosine of the same float32 argument is
    # not the correctly rounded one: there the port's lr is the reference's
    # arithmetic on the correctly rounded cosine
    prog = np.clip((steps.astype(np.float32) - np.float32(warm))
                   / np.float32(max(total - warm, 1)), 0, 1).astype(np.float32)
    arg = (np.float32(math.pi) * prog).astype(np.float32)
    xla = np.asarray(jnp.cos(jnp.asarray(arg)))
    rounded = np.array([np.float32(math.cos(float(a))) for a in arg])
    off = (steps >= warm) & (xla != rounded)
    assert np.array_equal(got[~off], exp[~off]), steps[~off][got[~off] != exp[~off]]
    assert np.array_equal(got[off], base * 0.5 * (np.float32(1.0) + rounded[off]))
    assert off.mean() < 0.05  # XLA's cosine is off by one ulp at a few steps only


# ------------------------------------------- (b) nothing read back, all meta
class _OnlyMeta(TorchDispatchMode):
    """Fails on a read of a device value to the host and on any tensor, in
    or out, that is not meta; counts the ops."""

    READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.READS:
            raise AssertionError(f"{func} reads a device value back to the host")
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                raise AssertionError(f"{func} takes a {t.device} tensor {tuple(t.shape)}")
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                raise AssertionError(f"{func} makes a {t.device} tensor")
        self.ops += 1
        return out


@pytest.mark.parametrize("name,optimizer,remat", [
    ("llama3.2-3b", "adamw", "full"), ("llama3.2-3b", "adamw8bit", "none"),
    ("llama3.2-3b", "adafactor", "dots"), ("mamba2-130m", "adamw", "full"),
    ("mixtral-8x22b", "adamw", "full"),
])
def test_captured_function_reads_nothing_back(name, optimizer, remat):
    import dataclasses

    arch = dataclasses.replace(tget(name).reduced(), optimizer=optimizer, remat=remat)
    step_fn, opt_init = make_train_step(arch, TrainConfig(**KW, microbatches=2))
    params = meta_params(arch)
    opt_state = opt_init(params)
    batch = batch_specs(DataConfig(arch.vocab, 32, 4), arch)
    names = tuple(sorted(batch))
    step = torch.zeros((), dtype=torch.int32, device="meta")
    mode = _OnlyMeta()
    with mode:
        out = capturable_step(step_fn, params, opt_state, names)(
            *(batch[k] for k in names), step)
    assert mode.ops > 100
    assert all(t.is_meta and t.shape == () and t.dtype == torch.float32 for t in out)


# ------------------------------------ (c) the static-buffer path against JAX
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's jitted, donated ``Trainer`` for STEPS steps from PRNGKey(0)'s
    params (adafactor: no element of its update follows a cancelling sum's
    last bits, so one tolerance holds everywhere, as in
    ``tests/test_torch_train.py``)."""
    arch = _arch(get_config, dtype="float32", optimizer="adafactor")
    params0 = jax.tree.map(np.asarray, jT.init_params(arch, jax.random.PRNGKey(0)))
    tc = JTrainConfig(**KW, ckpt_every=1000, ckpt_dir=str(tmp_path_factory.mktemp("jax")))
    tr = JTrainer(arch=arch, tc=tc, data=JData(**DATA))

    def init_state():
        p = jax.tree.map(jnp.asarray, params0)
        return p, tr.opt_init(p)

    tr.init_state = init_state
    out = tr.run(STEPS)
    return {"params0": params0, "history": out["history"],
            "params": jax.tree.map(np.asarray, out["params"])}


def _port_trainer(root, params0):
    arch = _arch(tget, dtype="float32", optimizer="adafactor")
    tc = TrainConfig(**KW, ckpt_every=0, ckpt_dir=str(root))
    tr = Trainer(arch=arch, tc=tc, data=DataConfig(**DATA), device="cpu")

    def init_state():
        p = params_from_numpy(params0, "cpu")
        return p, tr.opt_init(p)

    tr.init_state = init_state
    return tr


def test_trainer_steps_match_jaxs_jitted_trainer(jax_run, tmp_path):
    tr = _port_trainer(tmp_path / "f32", jax_run["params0"])
    out = tr.run(STEPS)
    key = next(iter(tr.graphs.calls))
    assert tr.graphs.calls == {key: STEPS} and tr.graphs.captured == 0  # eager on the CPU
    assert [t.data_ptr() for t in tr._inputs] == [t.data_ptr() for t in tr.load(0)]
    for h, e in zip(out["history"], jax_run["history"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(h[k], e[k], **TOL)
    got = jax.tree_util.tree_leaves(params_to_numpy(out["params"]))
    for g, e in zip(got, jax.tree_util.tree_leaves(jax_run["params"])):
        np.testing.assert_allclose(g, e, **TOL)
    assert int(out["opt_state"].step) == STEPS
    # in bf16, the port's eager step on fresh batches and Python steps: the
    # same bits as the Trainer's
    tr = _tiny(tmp_path / "bf16")
    out = tr.run(STEPS)
    step_fn, opt_init = make_train_step(tr.arch, tr.tc)
    params = init_params(tr.arch, torch.Generator().manual_seed(tr.seed))
    state = opt_init(params)
    for step in range(STEPS):
        params, state, m = step_fn(params, state, make_batch(tr.data, step, device="cpu"), step)
        assert float(m["loss"]) == out["history"][step]["loss"]
    for a, b in zip(tree.leaves((params, state)), tree.leaves((out["params"], out["opt_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _tiny(root, ckpt_every=0):
    """The loop tests' tiny bf16 llama (``tests/test_torch_train_loop.py``)."""
    tc = TrainConfig(**{**KW, "total_steps": 8}, ckpt_every=ckpt_every, ckpt_dir=str(root))
    return Trainer(arch=_arch(tget), tc=tc, data=DataConfig(**DATA), device="cpu")


# ------------------------------------------ (d) a restart writes in place
def test_restart_restores_into_the_steps_tensors(tmp_path):
    ref = _tiny(tmp_path / "ref").run(8)
    crash = _tiny(tmp_path / "crash", ckpt_every=3)
    seen = []  # the Trainer's state tensors as each attempt starts

    def attempt(start):
        seen.append(None if crash._state is None else
                    [t.data_ptr() for t in tree.leaves(crash._state)])
        return crash.run(8, start_step=start, fail_at=5 if start != -1 else None)

    out = run_with_restarts(attempt, max_restarts=1)
    assert [h["step"] for h in out["history"]] == list(range(5)) + list(range(3, 8))
    assert seen[0] is None and seen[1] == [
        t.data_ptr() for t in tree.leaves((out["params"], out["opt_state"]))]
    for a, b in zip(tree.leaves((ref["params"], ref["opt_state"])),
                    tree.leaves((out["params"], out["opt_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    losses = {h["step"]: h["loss"] for h in ref["history"]}
    assert all(h["loss"] == losses[h["step"]] for h in out["history"])
