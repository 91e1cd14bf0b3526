"""The paged engine on a mesh: the port's ``ServeEngine(mesh=)`` under the
tensor-parallel (TP) mapping against the JAX package's ``ServeEngine(mesh=)``
and against the port's unmeshed engine, on a 2 x 2 ("data", "model") mesh:
the JAX one in a subprocess with 4 forced host devices on a
``jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)``
mesh under ``set_mesh(mesh)``, the port's on 4 gloo ranks, each on its
blocks of the weights and its kv heads, every row of every group on every
rank.

Reduced llama3.2-3b (dense), reduced mixtral-8x22b (moe: 8 experts split
over the model axis, a window of 64), and the one-shot-prefill families:
reduced paligemma-3b (vlm: 1 kv head, which the 2-wide model axis cannot
split, so its attention runs whole on every rank) and musicgen-medium
(audio: 4 kv heads, 2 a rank), each with 8 frontend prefix embeddings;
float32, the JAX weights carried over with ``params_from_numpy``.  Six
requests in two waves (the second submitted once the first has finished):
(w, kv) in {(4, 8), (8, 4), (16, 16)}, ``spec_k`` 2 on two of them (a w4
and a w8 draft), ragged prompts of 21-25 tokens, one sampled request
(temperature 0.8, top_p 0.9, seed 7), and a second-wave request whose first
two pages are a finished first-wave request's prompt (a prefix-cache hit;
the one-shot-prefill families keep no prefix cache, as in JAX, so none
there).  Its streams equal JAX's meshed engine's and the port's unmeshed
engine's token for token, and every rank returns the same streams.  After
the run each rank's pools hold its kv heads (1 of llama's and mixtral's 2,
2 of musicgen's 4, paligemma's 1 whole) and equal those heads of the
unmeshed engine's pools on every page the prefix cache holds (after the
run, every allocated page; every page of the pool where there is no prefix
cache), within a float32 summation-order tolerance (the row-split ``wo`` /
``wd`` partials are summed over ``model``).  Every captured-step key names
the split.  ``Server(mesh=)`` on llama3.2-3b and on paligemma-3b equals
JAX's ``Server(mesh=)``; the alltoall MoE dispatch raises with a mesh.
"""
import concurrent.futures
import dataclasses
import inspect
import json
import textwrap

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
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402
from test_torch_sharding import run_ranks  # noqa: E402

ARCHS = ["llama3.2-3b", "mixtral-8x22b", "paligemma-3b", "musicgen-medium"]
PREFIX_ARCHS = ("paligemma-3b", "musicgen-medium")  # one-shot prefill, no prefix cache
SERVER_ARCHS = ["llama3.2-3b", "paligemma-3b"]
ENGINE = dict(max_slots=4, num_pages=32, page_size=8)
# (wave, prompt length, new tokens, w_bits, kv_bits, spec_k, draft_bits, sampled)
REQUESTS = [
    (0, 23, 6, 4, 8, 0, 4, False),
    (0, 21, 6, 8, 4, 2, 4, False),
    (0, 25, 5, 16, 16, 0, 4, False),
    (0, 22, 5, 8, 4, 0, 4, True),
    (1, 24, 5, 4, 8, 0, 4, False),  # its first 2 pages are request 0's prompt
    (1, 22, 6, 16, 16, 2, 8, False),
]
HIT_TOKENS = 2 * ENGINE["page_size"]
SERVER_BUDGETS = [(9, 4), (7, 5), (11, 3)]  # (prompt length, new tokens)
SERVER = dict(batch_size=2, max_len=32)
# the pools' float tolerance: K / V of layers past the first carry the
# row-split partials' summation order (a few f32 ulps of the activations);
# a quantized payload may then round one step the other way
POOL_TOL = dict(rtol=1e-4, atol=1e-5)


def _requests(vocab: int) -> list[dict]:
    rng = np.random.default_rng(23)
    out = []
    for wave, n, new, w, kv, spec, draft, sampled in REQUESTS:
        prompt = rng.integers(0, vocab, n).astype(np.int32).tolist()
        out.append(dict(wave=wave, prompt=prompt, new=new, w=w, kv=kv, spec=spec, draft=draft,
                        sampled=sampled))
    out[4]["prompt"][:HIT_TOKENS] = out[0]["prompt"][:HIT_TOKENS]
    return out


def _drive(engine, reqs, sampling_cls, precision_cls):
    """Submit each wave once the one before has finished; the streams in
    submission order."""
    handles = []
    for wave in (0, 1):
        for r in reqs:
            if r["wave"] != wave:
                continue
            extra = dict(temperature=0.8, top_p=0.9, seed=7) if r["sampled"] else {}
            handles.append(engine.submit(
                np.asarray(r["prompt"], np.int32),
                sampling_cls(max_new_tokens=r["new"], **extra),
                precision_cls(w_bits=r["w"], kv_bits=r["kv"], spec_k=r["spec"],
                              draft_bits=r["draft"])))
        engine.run()
    return [[int(t) for t in h.out_tokens] for h in handles]


_LOAD = """
def load(name, out, dtype="float32"):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    flat = np.load(f"{out}/{name}.npz")
    params = {}
    for path in flat.files:
        *head, last = path.split("/")
        d = params
        for h in head:
            d = d.setdefault(h, {})
        d[last] = flat[path]
    return cfg, params
"""

_JAX = """
import dataclasses, json
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed import sharding as sh
from repro.serve import PrecisionParams, SamplingParams, ServeEngine
from repro.train.server import Request, Server
{load}
{drive}
OUT, NAME = {out!r}, {name!r}
job = json.load(open(OUT + "/job.json"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
sh.set_mesh(mesh)
res = {{}}
cfg, params = load(NAME, OUT)
params = jax.tree.map(jax.numpy.asarray, params)
eng = ServeEngine(cfg, params, mesh=mesh, **job["engine"])
res[NAME] = _drive(eng, job["requests"][NAME], SamplingParams, PrecisionParams)
res[NAME + ":hits"] = eng.stats.prefix_hit_tokens
if NAME in job["server_archs"]:
    srv = Server(cfg, params, mesh=mesh, **job["server"])
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
            for i, (p, m) in enumerate(job["server_prompts"])]
    srv.serve(reqs)
    res["server:" + NAME] = [list(map(int, r.out_tokens)) for r in reqs]
json.dump(res, open(f"{{OUT}}/jax-{{NAME}}.json", "w"))
print("jax done")
"""

_PORT = """
    import dataclasses, json
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.params import PrecisionParams, SamplingParams
    from repro_torch.train.server import Request, Server
    {load}
    {drive}
    job = json.load(open(OUT + "/job.json"))
    mesh = make_test_mesh(2, 2, device="cpu")
    res = {{"coordinate": list(mesh.get_coordinate())}}
    for name in job["archs"]:
        cfg, params = load(name, OUT)
        eng = ServeEngine(cfg, params_from_numpy(params, "cpu"), device="cpu", mesh=mesh,
                          **job["engine"])
        res[name] = _drive(eng, job["requests"][name], SamplingParams, PrecisionParams)
        res[name + ":hits"] = eng.stats.prefix_hit_tokens
        res[name + ":splits"] = sorted({{repr(key[2][-1]) for key in eng.graphs.calls}})
        res[name + ":split"] = repr(eng.split)
        pools = {{}}
        for kv, cache in eng._caches.items():
            pc = eng.prefix_cache_for(kv)
            pages = sorted(pc._entries.values()) if pc else list(range(cache.num_pages))
            pools[f"{{kv}}:pages"] = np.asarray(pages, np.int64)
            for part, t in zip(("k", "v", "ks", "vs"), cache.pools):
                if t is not None:
                    pools[f"{{kv}}:{{part}}"] = t.numpy()
        np.savez(f"{{OUT}}/{{name}}-pools-{{RANK}}.npz", **pools)
    for name in job["server_archs"]:
        cfg, params = load(name, OUT)
        srv = Server(cfg, params_from_numpy(params, "cpu"), device="cpu", mesh=mesh,
                     **job["server"])
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=m)
                for i, (p, m) in enumerate(job["server_prompts"])]
        srv.serve(reqs)
        res["server:" + name] = [list(map(int, r.out_tokens)) for r in reqs]
    json.dump(res, open(f"{{OUT}}/port-{{RANK}}.json", "w"))
    print("port done")
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _server_prompts(vocab: int) -> list:
    rng = np.random.default_rng(9)
    return [(rng.integers(0, vocab, n).astype(np.int32).tolist(), m) for n, m in SERVER_BUDGETS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The JAX runs (one process an arch) and one 4-rank port run for the
    module, side by side."""
    out = tmp_path_factory.mktemp("engine_tp")
    params, reqs = {}, {}
    for i, name in enumerate(ARCHS):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        params[name] = jax.tree.map(np.asarray, jT.init_params(cfg, jax.random.PRNGKey(3 + i)))
        np.savez(out / f"{name}.npz", **_flat(params[name]))
        reqs[name] = _requests(cfg.vocab)
    vocab = get_config(ARCHS[0]).reduced().vocab
    (out / "job.json").write_text(json.dumps(dict(
        archs=ARCHS, server_archs=SERVER_ARCHS, engine=ENGINE, requests=reqs, server=SERVER,
        server_prompts=_server_prompts(vocab))))
    drive = textwrap.dedent(inspect.getsource(_drive))
    with concurrent.futures.ThreadPoolExecutor(len(ARCHS)) as pool:
        jax_runs = [pool.submit(subproc, _JAX.format(load=_LOAD, drive=drive, out=str(out),
                                                     name=name), n_devices=4, timeout=600)
                    for name in ARCHS]
        outs = run_ranks(_PORT.format(load=textwrap.indent(_LOAD, "    ").lstrip(),
                                      drive=textwrap.indent(drive, "    ").lstrip()), 4, out,
                         timeout=300)
        assert all("jax done" in run.result().stdout for run in jax_runs)
    assert all("port done" in o for o in outs)
    ranks = [json.loads((out / f"port-{r}.json").read_text()) for r in range(4)]
    theirs = {}
    for name in ARCHS:
        theirs.update(json.loads((out / f"jax-{name}.json").read_text()))
    return dict(out=out, jax=theirs, ranks=ranks, params=params, reqs=reqs)


@pytest.fixture(scope="module")
def plain(runs):
    """The port's unmeshed engine over the same requests, each arch ->
    (streams, engine)."""
    out = {}
    for name in ARCHS:
        cfg = dataclasses.replace(tget(name).reduced(), dtype="float32")
        eng = ServeEngine(cfg, params_from_numpy(runs["params"][name], "cpu"), device="cpu",
                          **ENGINE)
        out[name] = _drive(eng, runs["reqs"][name], SamplingParams, PrecisionParams), eng
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_meshed_engine_matches_jax_meshed_and_unmeshed_engines(name, runs, plain):
    ranks, theirs = runs["ranks"], runs["jax"]
    assert all(r[name] == ranks[0][name] for r in ranks)  # every rank returns them
    assert ranks[0][name] == theirs[name]
    assert [len(s) for s in theirs[name]] == [r[2] for r in REQUESTS]
    streams, eng = plain[name]
    assert ranks[0][name] == streams
    # the second wave's request 4 adopted request 0's two prompt pages,
    # where the engine keeps a prefix cache
    hits = 0 if name in PREFIX_ARCHS else HIT_TOKENS
    assert all(r[name + ":hits"] == hits for r in ranks)
    assert theirs[name + ":hits"] == eng.stats.prefix_hit_tokens == hits
    assert eng.stats.spec_rounds > 0 and eng.stats.mixed_precision_steps > 0


@pytest.mark.parametrize("name", ARCHS)
def test_meshed_pools_hold_this_ranks_kv_heads(name, runs, plain):
    """Each rank's pools: its kv heads of the unmeshed engine's pools (all
    of them where the 2-wide model axis does not divide them), on every
    page the prefix cache holds after the run (every page where there is
    none)."""
    _, eng = plain[name]
    cfg = eng.cfg
    m_size = 2 if cfg.n_kv_heads % 2 == 0 else 1
    hkv = cfg.n_kv_heads // m_size
    assert hkv == {"paligemma-3b": 1, "musicgen-medium": 2}.get(name, 1)
    for rank, res in enumerate(runs["ranks"]):
        m = res["coordinate"][1] if m_size > 1 else 0
        got = np.load(runs["out"] / f"{name}-pools-{rank}.npz")
        assert sorted({k.split(":")[0] for k in got.files}) == sorted(
            str(kv) for kv in eng._caches)
        for kv, cache in eng._caches.items():
            pages = got[f"{kv}:pages"]
            pc = eng.prefix_cache_for(kv)
            assert pages.tolist() == (sorted(pc._entries.values()) if pc
                                      else list(range(cache.num_pages)))
            assert len(pages) > 0
            ref = dict(zip(("k", "v", "ks", "vs"), (None if t is None else t.numpy()
                                                    for t in cache.pools)))
            assert got[f"{kv}:k"].shape[-2] == hkv
            for part in ("k", "v"):
                mine = got[f"{kv}:{part}"][:, pages]
                whole = ref[part][:, pages, :, m * hkv:(m + 1) * hkv]
                if kv == 16:
                    np.testing.assert_allclose(mine, whole, **POOL_TOL, err_msg=f"{kv} {part}")
                    continue
                scale_m = got[f"{kv}:{part}s"][:, pages]
                scale_w = ref[part + "s"][:, pages, :, m * hkv:(m + 1) * hkv]
                np.testing.assert_allclose(scale_m, scale_w, **POOL_TOL,
                                           err_msg=f"{kv} {part} scale")
                if kv == 4:  # two nibbles a byte along the head dim
                    mine, whole = _nibbles(mine), _nibbles(whole)
                step = np.abs(mine.astype(np.int32) - whole.astype(np.int32))
                assert step.max() <= 1, (kv, part, step.max())
                assert (step > 0).mean() < 1e-3, (kv, part, (step > 0).mean())


def _nibbles(a: np.ndarray) -> np.ndarray:
    lo = (a.astype(np.int16) << 12).astype(np.int16) >> 12
    hi = a.astype(np.int16) >> 4
    return np.stack([lo, hi], axis=-1)


@pytest.mark.parametrize("name", ARCHS)
def test_every_captured_step_key_names_the_split(name, runs, plain):
    for r in runs["ranks"]:
        assert r[name + ":splits"] == [r[name + ":split"]]
        split = r[name + ":split"]
        assert "'tp'" in split and str(tuple(r["coordinate"])) in split
    assert {key[2][-1] for key in plain[name][1].graphs.calls} == {None}


def _server_matches(runs, name):
    key = "server:" + name
    ranks = runs["ranks"]
    assert all(r[key] == ranks[0][key] for r in ranks)
    assert ranks[0][key] == runs["jax"][key]
    assert [len(s) for s in ranks[0][key]] == [m for _, m in SERVER_BUDGETS]


def test_server_mesh_engine_matches_jax_server_mesh(runs):
    _server_matches(runs, "llama3.2-3b")


def test_server_mesh_engine_matches_jax_server_mesh_one_shot_prefill(runs):
    """paligemma-3b: ``Server(mesh=)`` passes its mesh to the engine, whose
    one-shot prefill runs under the mapping."""
    _server_matches(runs, "paligemma-3b")


def test_alltoall_takes_no_mesh():
    moe = dataclasses.replace(tget("mixtral-8x22b").reduced(), moe_dispatch="alltoall")
    with pytest.raises(NotImplementedError,
                       match="takes no moe_dispatch='alltoall', as the JAX package's paged"):
        ServeEngine(moe, tT.init_params(moe, torch.Generator().manual_seed(0)), device="cpu",
                    mesh=object())
