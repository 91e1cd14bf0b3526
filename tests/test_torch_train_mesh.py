"""The port's mesh train step (``train/trainer.py``, the FSDP/ZeRO-3 mapping
over a DeviceMesh) against the JAX package's UNSHARDED step, and the mesh
launcher.

The JAX package's own mesh step cannot run on this jax (its
``with_sharding_constraint`` meets ``jax.make_mesh``'s Explicit axes), so
the reference is its unsharded step, which XLA's SPMD step equals.  On
4 gloo ranks, 2 x 2 and 4 x 1 ("data", "model") meshes: the JAX trainer
tests' tiny llama (2 layers, d_model 64, vocab 256, batch 8 x 64) and a
reduced mamba2-130m (batch 8 x 48), float32, adamw and adafactor, 2 steps
(no warm-up) from the JAX weights, each rank on its own rows: the loss, ce
and grad norm within ``rtol = atol = 1e-5`` and every parameter gathered
from its blocks within ``1e-5`` of the unsharded step's, except, under
adamw, where the reference's gradient of some step lies below 1e-6: there
Adam's ``g / (|g| + eps)`` follows a cancelling sum's last bits, and the two
may differ by up to 2 x lr a step (``tests/test_torch_train.py``'s rule).
The unsharded reference is JAX's and the port's for llama; for
mamba2-130m, whose reduced gradient the port matches to PR 17's 1e-4 only,
the port's within 1e-4 and JAX's first step within 1e-4.  Also on 4 x 1: a
``Trainer`` run on the mesh, checkpointed host-gathered every 2 steps,
crashing at step 3 and resumed, ends bit-equal to an uninterrupted one.

The launcher: ``--mesh-data 1 --device cpu`` runs in one process and prints
the JAX launcher's keys; ``--mesh-data 2 --mesh-model 2`` under ``torchrun``
(4 processes) trains reduced llama3.2-3b (bf16), under the tensor-parallel
mapping the launcher installs (``sharding.set_mesh(mesh)``, as the JAX
launcher does), to the unsharded run's losses within bf16's sums; the rows
of the global batch a rank draws.  The mesh steps above install no mapping
and so run the FSDP one.
"""
import dataclasses
import json
import os
import subprocess
import sys

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
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.trainer import mesh_rows, value_and_grad  # noqa: E402
from test_torch_sharding import ROOT, run_ranks  # noqa: E402
from test_torch_train import SIGN_LIKE, TINY, TOL  # noqa: E402

COMBOS = [(a, o) for a in ("llama3.2-3b", "mamba2-130m") for o in ("adamw", "adafactor")]
MESHES = [(2, 2), (4, 1)]
STEPS, LR = 2, 3e-3
SEQ = {"llama3.2-3b": 64, "mamba2-130m": 48}
MAMBA_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_train_model.py's TOL


def _over(name: str, optimizer: str) -> dict:
    extra = TINY if name == "llama3.2-3b" else {}
    return dict(extra, dtype="float32", optimizer=optimizer)


def _data(name: str) -> dict:
    vocab = TINY["vocab"] if name == "llama3.2-3b" else get_config(name).reduced().vocab
    return dict(vocab=vocab, seq_len=SEQ[name], global_batch=8, seed=2)


def _sign_like(tiny, grads):
    return jax.tree.map(lambda t, g: t | (np.abs(np.asarray(g)) < SIGN_LIKE), tiny, grads)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per combo, from the JAX weights (saved as the port's tree for the
    ranks): JAX's unsharded run and the port's, each as its metrics per
    step, its final params and where its gradient was sign-like."""
    out_dir = tmp_path_factory.mktemp("jax_train")
    runs = {}
    for name, opt in COMBOS:
        jarch = dataclasses.replace(get_config(name).reduced(), **_over(name, opt))
        tarch = dataclasses.replace(tget(name).reduced(), **_over(name, opt))
        kw = dict(lr=LR, warmup=0, total_steps=10, grad_clip=1.0)
        jstep, jinit = jmake_train_step(jarch, JTrainConfig(**kw))
        tstep, tinit = make_train_step(tarch, TrainConfig(**kw))
        jparams = jT.init_params(jarch, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        torch.save(tparams, out_dir / f"{name}-{opt}.pt")
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        jst, tst = jinit(jparams), tinit(tparams)
        jstep = jax.jit(jstep)
        jgrad = jax.jit(jax.grad(lambda p, b: jT.train_loss(p, b, jarch)[0]))
        jtiny = ttiny = jax.tree.map(lambda p: np.zeros(p.shape, bool), jparams)
        jmetrics, tmetrics = [], []
        for step in range(STEPS):
            jb = jmake(JData(**_data(name)), step)
            tb = make_batch(DataConfig(**_data(name)), step, device="cpu")
            if opt == "adamw":  # where Adam's step is sign-like (_hold)
                jtiny = _sign_like(jtiny, jgrad(jparams, jb))
                tg = value_and_grad(tparams, tb, tarch)[2]
                ttiny = _sign_like(ttiny, jax.tree.unflatten(jax.tree.structure(jparams),
                                                             [g.numpy() for g in tg]))
            jparams, jst, jm = jstep(jparams, jst, jb, jnp.asarray(step, jnp.int32))
            tparams, tst, tm = tstep(tparams, tst, tb, step)
            jmetrics.append({k: float(jm[k]) for k in ("loss", "ce", "grad_norm")})
            tmetrics.append({k: float(tm[k]) for k in ("loss", "ce", "grad_norm")})
        runs[(name, opt)] = {
            "jax": dict(metrics=jmetrics, params=jax.tree.map(np.asarray, jparams),
                        tiny=jtiny),
            "port": dict(metrics=tmetrics, params=params_to_numpy(tparams), tiny=ttiny)}
    return out_dir, runs


_RANKS = """
    import dataclasses, json
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import run_with_restarts
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig, Trainer, make_train_step

    D, M, COMBOS, DATA, OVER, STEPS, LR = json.load(open(f"{OUT}/job.json"))
    mesh = make_test_mesh(D, M, device="cpu")
    for name, opt in COMBOS:
        arch = dataclasses.replace(get_config(name).reduced(), **OVER[f"{name}-{opt}"])
        tc = TrainConfig(lr=LR, warmup=0, total_steps=10, grad_clip=1.0,
                         ckpt_dir=f"{OUT}/ckpt-{name}-{opt}-{RANK}")
        data = DataConfig(**DATA[name])
        rows = Trainer(arch=arch, tc=tc, data=data, device="cpu", mesh=mesh)
        step_fn, opt_init = make_train_step(arch, tc, mesh)
        full = torch.load(f"{OUT}/../{name}-{opt}.pt")
        params = reshard_state(full, mesh)
        opt_state = reshard_state(opt_init(full), mesh)
        metrics = []
        for step in range(STEPS):
            params, opt_state, m = step_fn(params, opt_state, rows.batch(step), step)
            metrics.append({k: float(v) for k, v in m.items()})
        gathered = tree.map(lambda t: sh.gather(t, t._mesh_sharding), params)
        if RANK == 0:
            flat = []
            sh._map_with_path(lambda p, leaf: flat.append((p, leaf)), params_to_numpy(gathered))
            np.savez(f"{OUT}/{name}-{opt}.npz", metrics=json.dumps(metrics),
                     **{"p:" + p: a for p, a in flat})
    if (D, M) == (4, 1):
        # a Trainer run on the mesh: crash at step 3, resume from step 2
        arch = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                                   **OVER["llama3.2-3b-adamw"])
        data = DataConfig(**DATA["llama3.2-3b"])

        def trainer(tag):
            tc = TrainConfig(lr=LR, warmup=1, total_steps=5, ckpt_every=2,
                             ckpt_dir=f"{OUT}/run-{tag}")
            return Trainer(arch=arch, tc=tc, data=data, device="cpu", mesh=mesh)

        ref = trainer("ref").run(5)
        crash = trainer("crash")
        out = run_with_restarts(
            lambda s: crash.run(5, start_step=s, fail_at=3 if s != -1 else None),
            max_restarts=2)
        assert [h["step"] for h in out["history"]] == [0, 1, 2, 2, 3, 4]
        for a, b in zip(tree.leaves((ref["params"], ref["opt_state"])),
                        tree.leaves((out["params"], out["opt_state"]))):
            assert torch.equal(a, b)
        assert [h["loss"] for h in out["history"][3:]] == \\
            [h["loss"] for h in ref["history"][2:]]
        if RANK == 0:
            print("resume bit-equal")
"""


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def port_runs(request, jax_runs):
    d, m = request.param
    out_dir = jax_runs[0] / f"mesh{d}x{m}"
    out_dir.mkdir()
    job = [d, m, COMBOS, {n: _data(n) for n, _ in COMBOS},
           {f"{n}-{o}": _over(n, o) for n, o in COMBOS}, STEPS, LR]
    (out_dir / "job.json").write_text(json.dumps(job))
    outs = run_ranks(_RANKS, 4, out_dir, timeout=300)
    return (d, m), out_dir, outs


def _hold(got, ref, opt, where, tol):
    """Metrics at every step within tol; each param within tol where the
    reference's gradient was never sign-like (adamw), else within 2 lr a
    step."""
    for gm, em in zip(json.loads(str(got["metrics"])), ref["metrics"]):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(gm[k], em[k], **tol, err_msg=f"{k} {where}")
    flat = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    for (kp, e), t in zip(flat, jax.tree_util.tree_leaves(ref["tiny"])):
        path = "/".join(str(k.key) for k in kp)
        g = got["p:" + path]
        if opt == "adafactor":  # its denominator is a row / column statistic
            t = np.zeros_like(t)
        np.testing.assert_allclose(g[~t], e[~t], **tol, err_msg=f"{path} {where}")
        assert np.abs(g[t] - e[t]).max(initial=0) <= 2 * LR * STEPS, (path, where)


@pytest.mark.parametrize("name,opt", COMBOS)
def test_mesh_step_matches_the_unsharded_step(name, opt, jax_runs, port_runs):
    """Against JAX's unsharded step (llama) and the port's (both archs).
    Reduced mamba2-130m's gradient is ill-conditioned (PR 17 held it to
    JAX's within 1e-4, ``MAMBA_TOL``): the port's unsharded step already
    differs from JAX's by that, which Adam turns into sign flips, and the
    order of the sum over ranks moves its second step's grad norm by up to
    3e-5 relative.  So there JAX's first step and the port's whole
    unsharded run are held within MAMBA_TOL."""
    (d, m), out_dir, outs = port_runs
    refs = jax_runs[1][(name, opt)]
    got = np.load(out_dir / f"{name}-{opt}.npz")
    if name == "llama3.2-3b":
        _hold(got, refs["port"], opt, f"vs the port's unsharded step on {d}x{m}", TOL)
        _hold(got, refs["jax"], opt, f"vs JAX's unsharded step on {d}x{m}", TOL)
    else:
        _hold(got, refs["port"], opt, f"vs the port's unsharded step on {d}x{m}", MAMBA_TOL)
        first = json.loads(str(got["metrics"]))[0]
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(first[k], refs["jax"]["metrics"][0][k], **MAMBA_TOL,
                                       err_msg=k)
    if (d, m) == (4, 1):
        assert "resume bit-equal" in outs[0]


def test_mesh_rows_split_every_microbatch():
    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 2)

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    assert mesh_rows(Mesh((0, 1)), 8) == [(2, 4)]
    assert mesh_rows(Mesh((1, 1)), 16, microbatches=2) == [(6, 8), (14, 16)]
    with pytest.raises(ValueError, match="does not split"):
        mesh_rows(Mesh((0, 0)), 6)


def test_launcher_mesh_1x1_runs_on_cpu(tmp_path, capsys):
    args = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--steps", "3",
            "--ckpt-dir"]
    report = tlaunch.main(args + [str(tmp_path / "mesh"), "--mesh-data", "1"])
    keys = {"arch", "steps", "first_loss", "final_loss", "mean_step_s", "stragglers"}
    assert set(report) == keys | {"device"} and report["steps"] == 3
    assert '"final_loss"' in capsys.readouterr().out
    assert not torch.distributed.is_initialized()  # the group joined here is left
    plain = tlaunch.main(args + [str(tmp_path / "plain")])
    # world size 1: the same step, bit for bit
    assert (report["first_loss"], report["final_loss"]) == \
        (plain["first_loss"], plain["final_loss"])


def test_launcher_under_torchrun_on_2x2(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
           "--standalone", "-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
           "--reduced", "--device", "cpu", "--steps", "3", "--mesh-data", "2",
           "--mesh-model", "2", "--ckpt-dir", str(tmp_path / "mesh")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout[proc.stdout.index("{"):proc.stdout.rindex("}") + 1])
    plain = tlaunch.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--steps",
                          "3", "--ckpt-dir", str(tmp_path / "plain")])
    assert report["steps"] == 3
    # the TP mapping in bf16: the row-split products (wo, wd) sum their f32
    # partials over the model ranks in another order than one bf16 matmul,
    # which flips ~4e-5 of the bf16 roundings (the first loss moved by 2.1e-5
    # relative); the float32 TP steps are held tightly against JAX's in
    # tests/test_torch_train_tp.py.  Then bf16 gradients summed over the
    # ranks in another order than one pass.
    np.testing.assert_allclose(report["first_loss"], plain["first_loss"], rtol=1e-4)
    np.testing.assert_allclose(report["final_loss"], plain["final_loss"], rtol=1e-3)
    assert sorted(os.listdir(tmp_path / "mesh")) == ["step_000000003"]
