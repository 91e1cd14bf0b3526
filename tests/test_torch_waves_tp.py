"""The static-wave ``Server(mesh=)`` under the tensor-parallel (TP) mapping
against the JAX package's ``Server(mesh=)``, on a 2 x 2 ("data", "model")
mesh: the JAX one in a subprocess with 4 forced host devices on a
``jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)``
mesh under ``set_mesh(mesh)``, the port's on 4 gloo ranks, each rank on its
blocks of the weights, its rows of a wave and its kv heads.

Reduced zamba2-7b (hybrid: SSM layers whole on every model rank, the shared
attention's 4 kv heads split over the 2-wide model axis; w8, kv8 through
the quantized ``decode_attention``) and reduced kimi-k2-1t-a32b (a dense
block, then MoE blocks whose 8 experts split over the model axis; w4, kv8),
float32, the JAX weights carried over.  5 requests with ragged prompts and
budgets at batch size 4: a wave of 4, whose rows split over ``data``, then a
wave of 1, which the data axis does not divide, so every rank holds it
whole.  Greedy streams token-identical to the JAX ``Server(mesh=)``'s, and
to the port's unsharded ``Server``'s; every rank returns the same streams.
The same kimi-k2 weights under ``moe_dispatch="alltoall"``: 8 requests at
batch size 4, two waves of 4 whose rows split over ``data``, each shard
routing its rows with its own capacity through both all-to-alls (the W4
experts through the CF matmul's plain version here), streams
token-identical to JAX's; a wave of 1 then raises ``ValueError`` in both.

The wave size is part of a captured step's key: on the 2-wide data axis a
wave of 6 (3 rows a rank) and a wave of 3 (whole, 3 rows a rank) hand
the decode step tokens of one shape, but read different caches and split
differently.  9 requests at batch size 6 take two steps, and their streams
equal the unsharded ``Server``'s; on a mesh ``decode_wave`` without the
wave's size raises.  An engine arch with the alltoall MoE dispatch and a
mesh raises, as the JAX engine takes none; every engine family takes a
mesh otherwise (tests/test_torch_engine_tp.py).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train.server import Request, Server  # noqa: E402
from test_torch_sharding import run_ranks  # noqa: E402

ARCHS = ["zamba2-7b", "kimi-k2-1t-a32b"]
BUDGETS = [(9, 5), (4, 3), (7, 4), (6, 2), (5, 3)]  # (prompt length, new tokens)
BATCH, MAX_LEN = 4, 24
# waves of 6 and 3 at batch size 6: as many rows a rank on a 2-wide data axis
KEY_BUDGETS = [(5, 2), (3, 2), (6, 2), (4, 2), (5, 2), (2, 2), (6, 2), (3, 2), (4, 2)]
KEY_BATCH = 6
# reduced kimi-k2-1t-a32b with moe_dispatch="alltoall": 8 requests at batch
# size 4, two waves of 4 whose rows split over data; then a wave of 1
A2A_ARCH = "kimi-k2-1t-a32b"
A2A_BUDGETS = BUDGETS + [(8, 4), (3, 2), (6, 3)]


def _prompts(vocab: int, budgets=BUDGETS) -> list:
    rng = np.random.default_rng(6)
    return [(rng.integers(0, vocab, n).astype(np.int32).tolist(), m) for n, m in budgets]


_JAX = """
import dataclasses, json
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed import sharding as sh
from repro.train.server import Request, Server

OUT = {out!r}
names, batch, max_len = json.load(open(OUT + "/job.json"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
sh.set_mesh(mesh)
streams = {{}}
for name in names:
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    flat = np.load(f"{{OUT}}/{{name}}.npz")
    params = {{}}
    for path in flat.files:
        *head, last = path.split("/")
        d = params
        for h in head:
            d = d.setdefault(h, {{}})
        d[last] = flat[path]
    params = jax.tree.map(jax.numpy.asarray, params)
    prompts = json.load(open(f"{{OUT}}/{{name}}-prompts.json"))
    srv = Server(cfg, params, batch_size=batch, max_len=max_len, mesh=mesh)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    srv.serve(reqs)
    streams[name] = [list(map(int, r.out_tokens)) for r in reqs]
    if name == {a2a!r}:  # the same weights under the alltoall dispatch
        srv = Server(dataclasses.replace(cfg, moe_dispatch="alltoall"), params,
                     batch_size=batch, max_len=max_len, mesh=mesh)
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
                for i, (p, m) in enumerate(json.load(open(f"{{OUT}}/a2a-prompts.json")))]
        srv.serve(reqs)
        streams["a2a"] = [list(map(int, r.out_tokens)) for r in reqs]
        try:  # a wave of 1, which the data axis does not divide
            srv.serve([Request(rid=0, prompt=np.asarray(prompts[0][0], np.int32),
                               max_new_tokens=2)])
            streams["a2a_odd"] = None
        except ValueError as exc:
            streams["a2a_odd"] = str(exc)
json.dump(streams, open(OUT + "/jax.json", "w"))
print("jax done")
"""

_PORT = """
    import dataclasses, json
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.server import Request, Server

    names, batch, max_len = json.load(open(f"{OUT}/job.json"))
    mesh = make_test_mesh(2, 2, device="cpu")
    streams = {}

    def load(name):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        flat = np.load(f"{OUT}/{name}.npz")
        params = {}
        for path in flat.files:
            *head, last = path.split("/")
            d = params
            for h in head:
                d = d.setdefault(h, {})
            d[last] = flat[path]
        return cfg, params_from_numpy(params, "cpu")

    def serve(srv, prompts):
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
                for i, (p, m) in enumerate(prompts)]
        srv.serve(reqs)
        assert all(r.done for r in reqs)
        return [list(map(int, r.out_tokens)) for r in reqs]

    for name in names:
        cfg, params = load(name)
        prompts = json.load(open(f"{OUT}/{name}-prompts.json"))
        srv = Server(cfg, params, batch_size=batch, max_len=max_len, device="cpu", mesh=mesh)
        streams[name] = serve(srv, prompts)
        if name == A2A_ARCH:  # the same weights under the alltoall dispatch
            srv = Server(dataclasses.replace(cfg, moe_dispatch="alltoall"), params,
                         batch_size=batch, max_len=max_len, device="cpu", mesh=mesh)
            streams["a2a"] = serve(srv, json.load(open(f"{OUT}/a2a-prompts.json")))
            try:  # a wave of 1, which the data axis does not divide
                serve(srv, [(prompts[0][0], 2)])
                streams["a2a_odd"] = None
            except ValueError as exc:
                streams["a2a_odd"] = str(exc)

    # waves of 6 and 3: 3 rows a rank each, two captured-step keys
    cfg, params = load(names[0])
    key_batch, key_prompts = json.load(open(f"{OUT}/key-job.json"))
    srv = Server(cfg, params, batch_size=key_batch, max_len=max_len, device="cpu", mesh=mesh)
    streams["key"] = serve(srv, key_prompts)
    streams["key_calls"] = sorted(srv.graphs.calls.values())
    try:
        srv.decode_wave(torch.zeros((3, 1), dtype=torch.long))
        raise AssertionError("decode_wave without b on a mesh did not raise")
    except ValueError:
        pass
    json.dump(streams, open(f"{OUT}/port-{RANK}.json", "w"))
    print("port done")
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def streams(tmp_path_factory, subproc):
    out = tmp_path_factory.mktemp("waves_tp")
    (out / "job.json").write_text(json.dumps([ARCHS, BATCH, MAX_LEN]))
    params = {}
    for i, name in enumerate(ARCHS):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        params[name] = jT.init_params(cfg, jax.random.PRNGKey(5 + i))
        np.savez(out / f"{name}.npz", **_flat(params[name]))
        (out / f"{name}-prompts.json").write_text(json.dumps(_prompts(cfg.vocab)))
    vocab = get_config(ARCHS[0]).reduced().vocab
    (out / "key-job.json").write_text(json.dumps([KEY_BATCH, _prompts(vocab, KEY_BUDGETS)]))
    a2a_vocab = get_config(A2A_ARCH).reduced().vocab
    (out / "a2a-prompts.json").write_text(json.dumps(_prompts(a2a_vocab, A2A_BUDGETS)))
    proc = subproc(_JAX.format(out=str(out), a2a=A2A_ARCH), n_devices=4, timeout=600)
    assert "jax done" in proc.stdout
    outs = run_ranks(_PORT.replace("A2A_ARCH", repr(A2A_ARCH)), 4, out, timeout=300)
    assert all("port done" in o for o in outs)
    ranks = [json.loads((out / f"port-{r}.json").read_text()) for r in range(4)]
    return json.loads((out / "jax.json").read_text()), ranks, params


@pytest.mark.parametrize("name", ARCHS)
def test_server_mesh_waves_match_jax_server_mesh(name, streams):
    theirs, ranks, params = streams
    assert all(r[name] == ranks[0][name] for r in ranks)  # every rank returns them
    assert ranks[0][name] == theirs[name]
    assert [len(s) for s in theirs[name]] == [m for _, m in BUDGETS]
    tcfg = dataclasses.replace(tget(name).reduced(), dtype="float32")
    plain = Server(tcfg, params_from_numpy(jax.tree.map(np.asarray, params[name]), "cpu"),
                   batch_size=BATCH, max_len=MAX_LEN, device="cpu")
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
            for i, (p, m) in enumerate(_prompts(tcfg.vocab))]
    plain.serve(reqs)
    assert [list(r.out_tokens) for r in reqs] == theirs[name]


def test_wave_size_keys_the_captured_step(streams):
    """Waves of 6 and 3 on a 2-wide data axis hand the step 3 rows each: two
    keys (the 2 and 1 decode steps of each wave), the unsharded streams."""
    _, ranks, params = streams
    name = ARCHS[0]
    assert all(r["key"] == ranks[0]["key"] for r in ranks)
    assert all(r["key_calls"] == [2, 2] for r in ranks)
    tcfg = dataclasses.replace(tget(name).reduced(), dtype="float32")
    plain = Server(tcfg, params_from_numpy(jax.tree.map(np.asarray, params[name]), "cpu"),
                   batch_size=KEY_BATCH, max_len=MAX_LEN, device="cpu")
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
            for i, (p, m) in enumerate(_prompts(tcfg.vocab, KEY_BUDGETS))]
    plain.serve(reqs)
    assert ranks[0]["key"] == [list(r.out_tokens) for r in reqs]
    tok = torch.zeros((3, 1), dtype=torch.long)
    assert plain.wave_key(tok, 6) != plain.wave_key(tok, 3)


def test_server_mesh_alltoall_waves_match_jax_server_mesh(streams):
    """Reduced kimi-k2 under ``moe_dispatch="alltoall"``: two waves of 4,
    each data shard routing its 2 rows with its own capacity; the greedy
    streams token-identical to JAX's ``Server(mesh=)`` on every rank."""
    theirs, ranks, _ = streams
    assert [len(s) for s in theirs["a2a"]] == [m for _, m in A2A_BUDGETS]
    assert all(r["a2a"] == theirs["a2a"] for r in ranks)


def test_alltoall_wave_the_data_axis_does_not_divide_raises(streams):
    """A wave of 1 on the 2-wide data axis: JAX's ``shard_map`` raises
    ``ValueError``, and so does the port's ``Server(mesh=)``."""
    theirs, ranks, _ = streams
    assert theirs["a2a_odd"] is not None and "divisible" in theirs["a2a_odd"]
    for r in ranks:
        assert r["a2a_odd"] == "a wave of 1 does not divide over the 2 data shards of " \
            "moe_dispatch='alltoall'", r["a2a_odd"]


def test_engine_family_with_a_mesh_raises():
    """What the meshed engine does not take raises through ``Server(mesh=)``,
    which passes its mesh to the engine: the alltoall MoE dispatch (every
    engine family takes a mesh otherwise)."""
    cfg = dataclasses.replace(tget("mixtral-8x22b").reduced(), moe_dispatch="alltoall")
    params = tT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError,
                       match="takes no moe_dispatch='alltoall', as the JAX package's paged"):
        Server(cfg, params, batch_size=2, max_len=32, device="cpu", mesh=object())
