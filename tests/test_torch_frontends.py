"""The vlm and audio archs (paligemma-3b, musicgen-medium) in the PyTorch
port against the JAX package.

``frontends.prefix_embeddings`` draws JAX's prefix from the same seed: the
uniforms under it bit-equal, the embeddings within 1e-6 absolute at float32
(XLA's ``erf_inv`` and the port's copy of it may round ``log1p`` otherwise).
On the reduced configs in float32, with the JAX weights carried over by
``params_from_numpy``: ``transformer.prefill`` over the prefix and the
prompt gives logits within the dense prefill's float32 tolerance
(tests/test_torch_model.py: 1e-3) and the same contiguous cache (int8
payloads at most one LSB apart in at most 1 of 1000 entries, as in
tests/test_torch_waves.py); ``PagedKVCache.write_prompt`` writes JAX's pages
bit for bit and keeps each pool's storage; and the engine's one-shot prefill
path emits the JAX engine's greedy streams token for token over a mixed (w,
kv) batch, spec off and on (spec_k 2, w4 draft), and one fixed-seed sampled
stream, each package drawing its own prefix from seed 0.  Inputs come from
numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

ARCHS = ("paligemma-3b", "musicgen-medium")
MIX = [(4, 8), (8, 4), (16, 16), (8, 8)]  # (w_bits, kv_bits), request i takes MIX[i]
_jprefill = jax.jit(jT.prefill, static_argnames=("cfg", "max_len"))


def _cfgs(name, **kw):
    over = dict(dtype="float32", **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    tcfg = dataclasses.replace(tget(name).reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    return cfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg, tcfg = _cfgs(request.param)
    params = jT.init_params(cfg, jax.random.PRNGKey(3))
    return cfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


# ------------------------------------------------------------ the frontend
@pytest.mark.parametrize("name,reduced,batch,seed", [
    ("paligemma-3b", True, 1, 0), ("paligemma-3b", True, 4, 0),
    ("musicgen-medium", True, 3, 5), ("musicgen-medium", False, 2, 0),
    ("paligemma-3b", False, 1, 2**32 - 1),
])
def test_prefix_embeddings_match_jax(name, reduced, batch, seed):
    cfg, tcfg = get_config(name), tget(name)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    cfg, tcfg = (dataclasses.replace(c, dtype="float32") for c in (cfg, tcfg))
    shape = (batch, cfg.prefix_len, cfg.d_model)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), batch)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    ju = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0)).reshape(-1)
    tkey = prng.fold_in(prng.prng_key(seed), batch)
    assert np.array_equal(prng.normal_uniforms(tkey, shape).numpy(), ju)
    exp = np.asarray(jfront.prefix_embeddings(cfg, batch, seed))
    got = tfront.prefix_embeddings(tcfg, batch, seed, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), exp, atol=1e-6, rtol=0)
    bf = tfront.prefix_embeddings(tget(name), 1, seed, device="cpu")
    assert bf.dtype == torch.bfloat16


def test_prefix_embeddings_refuse_archs_without_a_frontend():
    with pytest.raises(ValueError, match="no modality frontend"):
        tfront.prefix_embeddings(tget("llama3.2-3b"), 1, device="cpu")


# ------------------------------------------------------------- the model
def _check_cache(tcache, jcache):
    assert set(tcache) == set(jcache) and tcache["pos"] == int(jcache["pos"])
    for name, jv in jcache.items():
        if name == "pos":
            continue
        got, exp = tcache[name].numpy(), np.asarray(jv)
        if got.dtype == np.int8:
            off = got.astype(np.int32) != exp
            assert np.abs(got.astype(np.int32) - exp).max() <= 1, name
            assert off.mean() <= 1e-3, (name, int(off.sum()), off.size)
        else:
            np.testing.assert_allclose(got, exp, atol=1e-4 * np.abs(exp).max(), rtol=0)


@pytest.mark.parametrize("w_bits,kv_bits", [(16, 16), (8, 8), (4, 4)])
def test_prefill_with_prefix_matches_jax(models, w_bits, kv_bits):
    cfg, tcfg, params, ours = models
    cfg, tcfg = (dataclasses.replace(c, serve_kv_bits=kv_bits) for c in (cfg, tcfg))
    if w_bits < 16:
        params = jT.quantize_params(params, w_bits)
        ours = tT.quantize_params(ours, w_bits)
    tokens = np.random.default_rng(w_bits).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    max_len = cfg.prefix_len + 16
    jbatch = {"tokens": jnp.asarray(tokens), "prefix_emb": jfront.prefix_embeddings(cfg, 2)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "prefix_emb": tfront.prefix_embeddings(tcfg, 2, device="cpu")}
    jlog, jcache = _jprefill(params, jbatch, cfg=cfg, max_len=max_len)
    tlog, tcache = tT.prefill(ours, tbatch, tcfg, max_len)
    np.testing.assert_allclose(tlog.numpy()[:, : cfg.vocab], np.asarray(jlog)[:, : cfg.vocab],
                               atol=1e-3, rtol=1e-3)
    assert int(tcache["pos"]) == cfg.prefix_len + 9
    _check_cache(tcache, jcache)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_write_prompt_matches_jax_in_place(kv_bits):
    """A prefilled row scattered into a request's (non-contiguous) pages:
    JAX's pool bit for bit, and the port's pools keep their storage."""
    cfg, tcfg = _cfgs("musicgen-medium", serve_kv_bits=kv_bits)
    rng = np.random.default_rng(kv_bits)
    jc = JPagedKVCache(cfg, num_pages=12, page_size=4, kv_bits=kv_bits)
    tc = PagedKVCache(tcfg, num_pages=12, page_size=4, kv_bits=kv_bits, device="cpu")
    for c in (jc, tc):
        c.allocate(0, 2)  # another request's pages first: rid 1's are not 0..n
        c.allocate(1, 3)
    assert jc.table(1) == tc.table(1)
    dk = tcfg.hd // 2 if kv_bits == 4 else tcfg.hd
    shape = (tcfg.n_layers, 12, tcfg.n_kv_heads, dk)
    if kv_bits < 16:
        rows = [rng.integers(-128, 128, shape).astype(np.int8) for _ in range(2)]
        rows += [rng.random((*shape[:-1], 1)).astype(np.float32) for _ in range(2)]
    else:
        rows = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    ptrs = [p.data_ptr() for p in tc.pools if p is not None]
    jc.write_prompt(1, *[jnp.asarray(r) for r in rows])
    tc.write_prompt(1, *[torch.from_numpy(r) for r in rows])
    assert [p.data_ptr() for p in tc.pools if p is not None] == ptrs
    for got, exp in zip(tc.pools, (jc.k, jc.v, jc.k_scale, jc.v_scale)):
        if got is not None:
            assert np.array_equal(got.numpy(), np.asarray(exp))
    with pytest.raises(ValueError, match="prompt cache len"):
        tc.write_prompt(1, *[torch.from_numpy(r[:, :8]) for r in rows])


# ------------------------------------------------------------ the engine
def _serve(engine_cls, sampling_cls, precision_cls, cfg, params, prompts, sampling, **kw):
    extra = {"device": "cpu"} if engine_cls is ServeEngine else {}
    eng = engine_cls(cfg, params, max_slots=4, page_size=8, **kw, **extra)
    reqs = [eng.submit(p, sampling_cls(max_new_tokens=5, **sampling(i)),
                       precision_cls(w_bits=MIX[i][0], kv_bits=MIX[i][1]))
            for i, p in enumerate(prompts)]
    eng.run()
    return [r.out_tokens for r in reqs], eng


def _both(models, sampling, **kw):
    cfg, tcfg, params, ours = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32) for _ in MIX]
    j_out, jeng = _serve(JEngine, JSampling, JPrecision, cfg, params, prompts, sampling, **kw)
    t_out, teng = _serve(ServeEngine, SamplingParams, PrecisionParams, tcfg, ours, prompts,
                         sampling, **kw)
    return j_out, jeng.stats, t_out, teng


@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_greedy_streams_match_jax(models, spec_k):
    """Four 12-token requests over (w, kv) in (4,8) (8,4) (16,16) (8,8),
    five new tokens each: one one-shot prefill group call per precision,
    then decode (or spec rounds at a w4 draft); no prefix cache."""
    j_out, j_stats, t_out, teng = _both(models, lambda i: {}, spec_k=spec_k, draft_bits=4)
    assert t_out == j_out and all(len(o) == 5 for o in t_out)
    st = teng.stats
    assert (st.prefills, st.prefill_chunks, st.prefix_hit_tokens) == (4, 0, 0)
    assert st.mixed_precision_steps == j_stats.mixed_precision_steps > 0
    assert (st.spec_rounds, st.spec_draft_tokens, st.spec_accepted_tokens) == (
        j_stats.spec_rounds, j_stats.spec_draft_tokens, j_stats.spec_accepted_tokens)
    assert (st.spec_rounds > 0) == (spec_k > 0)
    assert teng._prefix == {} and not teng._prefix_enabled


def test_engine_sampled_stream_matches_jax(models):
    """Temperature 0.8, top_p 0.95, top_k 50 on every other request, seed =
    index: the first token comes from the prefill's logits under the
    engine's keys, the rest from the captured steps' sampler."""
    def sampling(i):
        return {"temperature": 0.8, "top_p": 0.95, "top_k": 50 if i % 2 == 0 else 0,
                "seed": 11 + i}

    j_out, _, t_out, _ = _both(models, sampling)
    assert t_out == j_out and all(len(o) == 5 for o in t_out)
