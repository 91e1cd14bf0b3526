"""The port's train step under the tensor-parallel (TP) mapping
(``sharding.set_mesh(mesh)``, ``train/trainer.py``) against the JAX
package's own TP step, on 4 gloo ranks of 2 x 2 and 1 x 4 ("data", "model")
meshes.

The JAX step runs in a subprocess with 4 forced host devices on a
``jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)``
mesh under ``repro.distributed.sharding.set_mesh(mesh)``, its params placed
on ``tree_shardings``: ``jax.value_and_grad`` of ``train_loss`` (jitted) at
the initial params and at the params after one step, and two steps of
``make_train_step`` (jitted).  JAX's two steps run on the first mesh of
each config; its TP result is the unsharded program's, whatever the mesh,
up to the order of its sums, so both port meshes are held to it.  Under
the alltoall MoE dispatch each data shard routes its own tokens, so the
function depends on the mesh, and JAX's two steps run on every mesh.  The port
runs the same from the JAX weights, each rank on its rows (over ``data``)
and its stored blocks: ``mesh_value_and_grad`` at the initial params and
at JAX's params after one step (the same inputs as JAX's second
evaluation), and two steps of the mesh step: the first from the initial
params, the second from JAX's params after one step, with the port's own
optimizer state.
Reduced configs in float32, batch 8 x 32 (``seed`` 2), adamw at lr 3e-3
with no warm-up.

Held: the loss and ce of both gradient evaluations and of both steps, the
grad norm of both steps, every gradient leaf (gathered from the ranks'
blocks) at both evaluations, and every parameter after one step, where the
reference's gradient is not sign-like (``|g| < 1e-6``: Adam's ``g / (|g| +
eps)`` there follows a cancelling sum's last bits and may move a parameter
by up to 2 lr, ``tests/test_torch_train.py``'s rule).  The second step
starts from JAX's first-step params, and its parameters are not held leaf
by leaf: the sign-like updates of the first step, whichever params they
were taken from, move some elements' second-step gradient by ~1e-2
relative (and reduced zamba2-7b's grad norm by 7%), which Adam passes on
to the parameter.  For MoE configs
(``test_torch_train_tp_moe.py``), the assignments dropped at capacity in
every MoE layer of each evaluation's forward equal JAX's.

Tolerances (``TOLS``): llama3.2-3b and mixtral-8x22b rtol = atol = 1e-5 on
the metrics, the gradients and the parameters.  zamba2-7b: 1e-4 on the
metrics and the parameters; each gradient leaf's largest difference within
8 times JAX's own noise floor, the largest change of JAX's gradient when
every parameter moves one ulp up or down (``NOISE_FACTOR``, as
``tests/test_torch_train_model.py`` holds the reduced hybrid, whose
gradient is ill-conditioned), and there "sign-like" means within that
noise of 0.  On 1 x 4
reduced llama's 2 kv heads do not divide the model axis, so its attention
runs whole on every model rank and its MLP, embedding and unembedding
split: both branches of the rule.  zamba2-7b's SSM layers run whole and the
4 kv heads of its shared attention block split on both meshes.
"""
import dataclasses
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from test_torch_sharding import run_ranks  # noqa: E402

STEPS, LR, SIGN_LIKE = 2, 3e-3, 1e-6
DATA = dict(seq_len=32, global_batch=8, seed=2)
# per arch: (tolerance of the metrics and parameters, of the gradients; None:
# NOISE_FACTOR times JAX's one-ulp noise floor)
TOLS = {
    "llama3.2-3b": (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=1e-5)),
    "zamba2-7b": (dict(rtol=1e-4, atol=1e-4), None),
    "mixtral-8x22b": (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=1e-5)),
}
NOISE_FACTOR = 8
# (name, config overrides, mesh shape)
CASES = [("llama3.2-3b", {}, (2, 2)), ("llama3.2-3b", {}, (1, 4)),
         ("zamba2-7b", {}, (2, 2)), ("zamba2-7b", {}, (1, 4))]

_JAX = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.data.pipeline import DataConfig, make_batch
from repro.distributed import sharding as sh
from repro.models import moe, transformer as T
from repro.train import TrainConfig, make_train_step

OUT = sys.argv[1]
cases, data_kw, lr, steps, noisy, raising = json.load(open(OUT + "/job.json"))
calls = []
in_shard_map = [False]  # the alltoall dispatch: each device's call, by its data index
_pos = moe._positions_in_expert
def _record(eids, n):
    pos = _pos(eids, n)
    if in_shard_map[0]:
        jax.debug.callback(lambda p, d, m: calls.append((int(d), int(m), np.asarray(p))),
                           pos, jax.lax.axis_index("data"), jax.lax.axis_index("model"))
    else:
        jax.debug.callback(lambda p: calls.append(np.asarray(p)), pos)
    return pos
moe._positions_in_expert = _record

def drops_of(arch):
    # assignments dropped at capacity in each MoE call, and under the
    # alltoall dispatch in each call per data shard (model rank 0's)
    def drops(c):
        return int((c >= max(1, int(c.size * arch.capacity_factor) // arch.n_experts)).sum())
    if arch.moe_dispatch != "alltoall":
        return [drops(c) for c in calls]
    shards = sorted({d for d, _, _ in calls})
    per = [[drops(c) for d, m, c in calls if (d, m) == (s, 0)] for s in shards]
    return [list(x) for x in zip(*per)]

def flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in kp)] = np.asarray(leaf)
    return out

for tag, name, over, shape, ref_tag in cases:
    arch = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    sh.set_mesh(mesh)
    # the alltoall dispatch takes the mesh (JAX's Trainer(mesh=) passes it)
    in_shard_map[0] = arch.moe_dispatch == "alltoall"
    lmesh = mesh if in_shard_map[0] else None
    p0 = T.init_params(arch, jax.random.PRNGKey(0))
    res = {("p0:" + k): v for k, v in flat(p0).items()}
    p = jax.device_put(p0, sh.tree_shardings(p0, mesh))
    data = DataConfig(vocab=arch.vocab, **data_kw)
    vg = jax.jit(jax.value_and_grad(lambda p, b: T.train_loss(p, b, arch, lmesh),
                                    has_aux=True))

    def evaluate(p, i):
        calls.clear()
        b = make_batch(data, i)
        (loss, m), g = vg(p, b)
        jax.block_until_ready(g)
        jax.effects_barrier()  # every debug callback of this call has run
        res.update({f"g{i}:" + k: v for k, v in flat(g).items()})
        if name in noisy:  # JAX's own noise floor: every param one ulp up, one down
            for d in (np.inf, -np.inf):
                gn = flat(vg(jax.tree.map(lambda a: jnp.nextafter(a, d), p), b)[1])
                for k, v in flat(g).items():
                    res[f"n{i}:" + k] = max(res.get(f"n{i}:" + k, 0.0),
                                            float(np.abs(gn[k] - v).max()))
        return {"loss": float(loss), "ce": float(m["ce"]), "drops": drops_of(arch)}

    evals = [evaluate(p, 0)]
    metrics = []
    if tag == ref_tag:  # the two steps, once per config (alltoall: per mesh)
        step, init = make_train_step(arch, TrainConfig(lr=lr, warmup=0, total_steps=10,
                                                       grad_clip=1.0), lmesh)
        step = jax.jit(step)
        st = init(p)
        for i in range(steps):
            if i:
                evals.append(evaluate(p, i))
            p, st, m = step(p, st, make_batch(data, i), jnp.asarray(i, jnp.int32))
            metrics.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm")})
            if i == 0:
                res.update({("p1:" + k): v for k, v in flat(p).items()})
    np.savez(f"{OUT}/jax-{tag}.npz", evals=json.dumps(evals), metrics=json.dumps(metrics),
             **res)
    sh.set_mesh(None)
in_shard_map[0] = False
raised = {}
for tag, name, over, shape in raising:  # configs the mesh does not take: the error
    arch = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    sh.set_mesh(mesh)
    p0 = T.init_params(arch, jax.random.PRNGKey(0))
    p = jax.device_put(p0, sh.tree_shardings(p0, mesh))
    b = make_batch(DataConfig(vocab=arch.vocab, **data_kw), 0)
    try:
        jax.jit(jax.value_and_grad(lambda p, b: T.train_loss(p, b, arch, mesh),
                                   has_aux=True))(p, b)
        raised[tag] = None
    except (TypeError, ValueError) as exc:
        raised[tag] = f"{type(exc).__name__}: {exc}"
    sh.set_mesh(None)
json.dump(raised, open(f"{OUT}/jax-raised.json", "w"))
print("jax done")
"""

_PORT = """
    import dataclasses, json
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import tree
    from repro_torch.train import TrainConfig, Trainer, make_train_step
    from repro_torch.train.trainer import mesh_value_and_grad

    calls = []
    _pos = moe._positions_in_expert
    def _record(eids, n):
        pos = _pos(eids, n)
        calls.append(pos.clone())
        return pos
    moe._positions_in_expert = _record

    cases, data_kw, lr, steps, _, raising = json.load(open(f"{OUT}/job.json"))

    def drops_of(arch, mesh):
        # as the JAX script's: per MoE call, and under the alltoall dispatch
        # per data shard (model rank 0's), gathered from the ranks
        drops = [int((c >= max(1, int(c.numel() * arch.capacity_factor) // arch.n_experts))
                     .sum()) for c in calls]
        if arch.moe_dispatch != "alltoall":
            return drops
        every = [None] * WORLD
        dist.all_gather_object(every, (tuple(mesh.get_coordinate()), drops))
        per = [dr for (d, m), dr in sorted(every) if m == 0]
        return [list(x) for x in zip(*per)]

    def nested(flat):
        out = {}
        for path, a in flat.items():
            *head, last = path.split("/")
            d = out
            for h in head:
                d = d.setdefault(h, {})
            d[last] = np.asarray(a)
        return out

    def paths(t):  # in flattening order
        return tree.leaves(sh._map_with_path(lambda p, leaf: p, t))

    for tag, name, over, shape, ref_tag in cases:
        ref = np.load(f"{OUT}/jax-{tag}.npz")
        ref1 = np.load(f"{OUT}/jax-{ref_tag}.npz")  # the run that took JAX's two steps
        arch = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
        mesh = make_test_mesh(*shape, device="cpu")
        def params_at(npz, key):
            return params_from_numpy(nested({k[3:]: npz[k] for k in npz.files
                                             if k.startswith(key)}), "cpu")

        full = params_at(ref, "p0:")
        res = {}
        with sh.use_mesh(mesh):
            tc = TrainConfig(lr=lr, warmup=0, total_steps=10, grad_clip=1.0,
                             ckpt_dir=f"{OUT}/ckpt-{tag}-{RANK}")
            trainer = Trainer(arch=arch, tc=tc, data=DataConfig(vocab=arch.vocab, **data_kw),
                              device="cpu", mesh=mesh)
            step_fn, opt_init = make_train_step(arch, tc, mesh)
            params = reshard_state(full, mesh)
            opt_state = reshard_state(opt_init(full), mesh)

            def evaluate(params, i):
                calls.clear()
                loss, ce, grads = mesh_value_and_grad(params, trainer.batch(i), arch, mesh)
                drops = drops_of(arch, mesh)
                g = [sh.gather(g, p._mesh_sharding) for g, p in zip(grads, tree.leaves(params))]
                res.update({f"g{i}:" + k: v.numpy()
                            for k, v in zip(paths(tree.unflatten(params, g)),
                                            tree.leaves(tree.unflatten(params, g)))})
                return {"loss": float(loss), "ce": float(ce), "drops": drops}

            evals = [evaluate(params, 0), evaluate(reshard_state(params_at(ref1, "p1:"), mesh), 1)]
            metrics = []
            for i in range(steps):
                params, opt_state, m = step_fn(params, opt_state, trainer.batch(i), i)
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0:
                    p1 = tree.map(lambda t: sh.gather(t, t._mesh_sharding).clone(), params)
                    res.update({"p1:" + k: v.numpy() for k, v in zip(paths(p1), tree.leaves(p1))})
                    # the second step from JAX's first-step params
                    for t, j in zip(tree.leaves(params),
                                    tree.leaves(reshard_state(params_at(ref1, "p1:"), mesh))):
                        t.copy_(j)
        if RANK == 0:
            np.savez(f"{OUT}/port-{tag}.npz", evals=json.dumps(evals),
                     metrics=json.dumps(metrics), **res)
    raised = {}
    for tag, name, over, shape in raising:  # configs the mesh does not take: the error
        arch = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
        mesh = make_test_mesh(*shape, device="cpu")
        tc = TrainConfig(ckpt_dir=f"{OUT}/ckpt-{tag}-{RANK}")
        with sh.use_mesh(mesh):
            trainer = Trainer(arch=arch, tc=tc, data=DataConfig(vocab=arch.vocab, **data_kw),
                              device="cpu", mesh=mesh)
            params, _ = trainer.init_state()
            try:
                mesh_value_and_grad(params, trainer.batch(0), arch, mesh)
                raised[tag] = None
            except ValueError as exc:
                raised[tag] = f"{type(exc).__name__}: {exc}"
    if RANK == 0:
        json.dump(raised, open(f"{OUT}/port-raised.json", "w"))
    print("port done")
"""


def _tag(name, over, shape) -> str:
    extra = "".join(f"-{k}{v}" for k, v in sorted(over.items()))
    return f"{name}{extra}-{shape[0]}x{shape[1]}"


def run_cases(cases, out_dir, subproc, raising=()):
    """The JAX reference (one subprocess, 4 host devices) and the port (4
    gloo ranks) over ``cases`` -> {tag: (jax npz, port npz)}; with
    ``raising``, cases whose first gradient evaluation should raise, also
    {"raised": {tag: (JAX's error, the port's)}} (None where none was)."""
    job = [[_tag(name, over, shape), name, over, list(shape),
            _tag(name, over, _steps_mesh(cases, name, over, shape))]
           for name, over, shape in cases]
    noisy = [n for n, (_, gtol) in TOLS.items() if gtol is None]
    raise_job = [[_tag(*c), *c[:2], list(c[2])] for c in raising]
    (out_dir / "job.json").write_text(json.dumps([job, DATA, LR, STEPS, noisy, raise_job]))
    proc = subproc(_JAX.replace("OUT = sys.argv[1]", f"OUT = {str(out_dir)!r}"),
                   n_devices=4, timeout=600)
    assert "jax done" in proc.stdout
    outs = run_ranks(_PORT, 4, out_dir, timeout=300)
    assert all("port done" in o for o in outs)
    out = {t: (np.load(out_dir / f"jax-{t}.npz"), np.load(out_dir / f"port-{t}.npz"))
           for t, *_ in job}
    if raising:
        theirs, ours = (json.loads((out_dir / f"{w}-raised.json").read_text())
                        for w in ("jax", "port"))
        out["raised"] = {t: (theirs[t], ours[t]) for t, *_ in raise_job}
    return out


def _steps_mesh(cases, name, over, shape) -> tuple:
    """The mesh whose JAX run takes the config's two steps: its first in
    ``cases``, since JAX's TP result is the unsharded program's whatever the
    mesh; under the alltoall dispatch each mesh's own, since routing and
    capacity are per data shard there, so the function depends on the
    mesh."""
    if over.get("moe_dispatch") == "alltoall":
        return tuple(shape)
    return next(tuple(s) for n, o, s in cases if (n, o) == (name, over))


def _two_step_ref(results, name, over, shape):
    """The JAX run of the config that took the two steps (``_steps_mesh``)."""
    shapes = [tuple(shape)] if over.get("moe_dispatch") == "alltoall" else [(2, 2), (1, 4)]
    for s in shapes:
        j = results.get(_tag(name, over, s), (None,))[0]
        if j is not None and json.loads(str(j["metrics"])):
            return j
    raise AssertionError(f"no two-step JAX run of {name} {over}")


def hold(results, name, over, shape, moe=False):
    """The checks of the module note for one case."""
    mtol, gtol = TOLS[name]
    j, p = results[_tag(name, over, shape)]
    jr = _two_step_ref(results, name, over, shape)
    pe = json.loads(str(p["evals"]))
    je = [json.loads(str(j["evals"]))[0], json.loads(str(jr["evals"]))[1]]
    where = f"{name} {over} on {shape[0]}x{shape[1]}"
    for i, (a, b) in enumerate(zip(pe, je)):
        for k in ("loss", "ce"):
            np.testing.assert_allclose(a[k], b[k], **mtol, err_msg=f"eval {i} {k} {where}")
        if moe:
            assert a["drops"] == b["drops"], (i, a["drops"], b["drops"], where)
            assert np.sum(a["drops"]) > 0, where  # capacity binds
        ref = j if i == 0 else jr
        keys = [k for k in ref.files if k.startswith(f"g{i}:")]
        assert keys and len(keys) == len([k for k in p.files if k.startswith(f"g{i}:")])
        for k in keys:
            if gtol is None:
                noise = float(ref["n" + k[1:]])
                assert np.abs(p[k] - ref[k]).max() <= NOISE_FACTOR * noise, (k, noise, where)
            else:
                np.testing.assert_allclose(p[k], ref[k], **gtol, err_msg=f"grad {k} {where}")
    for i, (a, b) in enumerate(zip(json.loads(str(p["metrics"])),
                                   json.loads(str(jr["metrics"])))):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], **mtol, err_msg=f"step {i} {k} {where}")
    keys = [k for k in jr.files if k.startswith("p1:")]
    assert keys
    for k in keys:
        path = k[3:]
        floor = SIGN_LIKE
        if gtol is None:
            floor = max(SIGN_LIKE, NOISE_FACTOR * float(jr[f"n0:{path}"]))
        tiny = np.abs(jr[f"g0:{path}"]) < floor
        g, e = p[k], jr[k]
        np.testing.assert_allclose(g[~tiny], e[~tiny], **(gtol or mtol),
                                   err_msg=f"param {path} {where}")
        assert np.abs(g[tiny] - e[tiny]).max(initial=0) <= 2 * LR, (path, where)


@pytest.fixture(scope="module")
def results(tmp_path_factory, subproc):
    return run_cases(CASES, tmp_path_factory.mktemp("train_tp"), subproc)


@pytest.mark.parametrize("name,over,shape", CASES, ids=[_tag(*c) for c in CASES])
def test_tp_step_matches_jax_tp_step(name, over, shape, results):
    hold(results, name, over, shape)
