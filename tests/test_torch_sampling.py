"""The port's seeded sampling against the JAX package's.

Op level: the port's threefry (kernels/prng.py) and ``sample_keys`` give
``jax.random``'s keys and uniforms bit for bit; ``_top_kp_mask`` gives
identical masks and ``sampling_probs`` probabilities within the reference's
own oracle tolerance (tests/test_sampling.py: atol 1e-6, rtol 1e-5);
``_inverse_cdf``, ``sample_from_probs`` and ``sample_tokens`` give JAX's
tokens at V in {256, 1000, 128256}.  Engine level: the float32 reduced
llama3.2-3b of tests/test_torch_engine.py, weights carried over with
params_from_numpy, serves fixed-seed sampled requests over mixed (w, kv)
and emits the JAX engine's streams token for token, under another batch
composition, under forced preemption, with warm prefix hits and through
the generate() event contract.  Inputs come from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import GenerationOutput as JOutput  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops, prng  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.outputs import GenerationOutput, StreamEvent  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

PROB_TOL = dict(atol=1e-6, rtol=1e-5)  # tests/test_sampling.py's oracle tolerance
SEEDS = [0, 1, 7, 2**31, 2**32 - 1]
POSITIONS = [0, 1, 3, 1000, 2**31 - 1]
# the (temperature, top_k, top_p) grid of tests/test_sampling.py
GRID = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.8, 10, 0.5), (2.0, 3, 0.95),
        (0.0, 5, 0.5)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _keys_np(seeds, positions, salt):
    """JAX's sample_keys as int64 numpy."""
    k = jops.sample_keys(jnp.asarray(seeds, jnp.uint32), jnp.asarray(positions, jnp.int32),
                         salt)
    return np.asarray(k).astype(np.int64)


# ------------------------------------------------------------------ PRNG
@pytest.mark.parametrize("seed,pos,salt,key,u", [
    (7, 3, 0, [2785874591, 2637538571], 0.43299568),
    (1234, 100, 2, [3880784540, 3271208263], 0.26160312),
])
def test_threefry_golden_vectors(seed, pos, salt, key, u):
    k = ops.sample_keys(torch.tensor([seed]), torch.tensor([pos]), salt)
    assert k.tolist() == [key]
    assert prng.uniform(k).item() == np.float32(u)


@pytest.mark.parametrize("salt", [0, 1, 2, 3])
def test_sample_keys_and_uniforms_match_jax_bit_for_bit(salt):
    seeds = np.repeat(np.array(SEEDS, np.uint64), len(POSITIONS))
    pos = np.tile(np.array(POSITIONS, np.int64), len(SEEDS))
    want = _keys_np(seeds.astype(np.uint32), pos.astype(np.int32), salt)
    got = ops.sample_keys(_t(seeds.astype(np.int64)), _t(pos), salt)
    np.testing.assert_array_equal(got.numpy(), want)
    u_jax = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(
        jnp.asarray(want.astype(np.uint32))))
    np.testing.assert_array_equal(prng.uniform(got).numpy(), u_jax)


def test_prng_key_and_fold_in_match_jax():
    for s in SEEDS:
        jk = jax.random.PRNGKey(np.uint32(s))
        assert prng.prng_key(torch.tensor(s)).tolist() == np.asarray(jk).tolist()
        for d in (0, 5, 2**32 - 1):
            want = np.asarray(jax.random.fold_in(jk, np.uint32(d))).tolist()
            assert prng.fold_in(prng.prng_key(torch.tensor(s)), torch.tensor(d)).tolist() == want


# -------------------------------------------------------- masks and probs
def _logits(rng, b, v):
    x = (rng.standard_normal((b, v)) * 2.0).astype(np.float32)
    x[0, 3:9] = x[0].max()  # a row of tied maxima: the sort's tie order shows
    x[1, :] = np.round(x[1])  # many ties everywhere
    return x


@pytest.mark.parametrize("temp,top_k,top_p", GRID)
def test_mask_and_probs_match_jax(temp, top_k, top_p):
    rng = np.random.default_rng(0)
    b, v = 8, 64
    lg = _logits(rng, b, v)
    tk, tp = np.full(b, top_k, np.int32), np.full(b, top_p, np.float32)
    temps = np.full(b, temp, np.float32)
    want_mask = np.asarray(jops._top_kp_mask(jnp.asarray(lg), jnp.asarray(tk), jnp.asarray(tp)))
    got_mask = ops._top_kp_mask(_t(lg), _t(tk), _t(tp)).numpy()
    np.testing.assert_array_equal(got_mask, want_mask)
    for k_arg, p_arg in ((tk, tp), (None, tp), (tk, None), (None, None)):
        want = np.asarray(jops.sampling_probs(
            jnp.asarray(lg), jnp.asarray(temps), None if k_arg is None else jnp.asarray(k_arg),
            None if p_arg is None else jnp.asarray(p_arg)))
        got = ops.sampling_probs(_t(lg), _t(temps), None if k_arg is None else _t(k_arg),
                                 None if p_arg is None else _t(p_arg)).numpy()
        np.testing.assert_allclose(got, want, **PROB_TOL)
        np.testing.assert_array_equal(got > 0, want > 0)


def test_probs_with_padded_vocab_match_jax():
    """Full-width vocabulary with -1e30 padding columns (certain ties) and
    mixed per-row knobs, one of them greedy."""
    rng = np.random.default_rng(1)
    b, v = 8, 128256
    lg = _logits(rng, b, v)
    lg[:, v - 9:] = -1e30
    temps = np.array([0.8, 1.0, 0.0, 1.3, 0.5, 0.9, 2.0, 0.7], np.float32)
    tk = np.array([50, 0, 5, 3, 0, 10, 0, 1], np.int32)
    tp = np.array([0.95, 0.9, 1.0, 0.5, 1.0, 0.3, 1.0, 0.9], np.float32)
    want_mask = np.asarray(jops._top_kp_mask(jnp.asarray(lg), jnp.asarray(tk), jnp.asarray(tp)))
    np.testing.assert_array_equal(ops._top_kp_mask(_t(lg), _t(tk), _t(tp)).numpy(), want_mask)
    want = np.asarray(jops.sampling_probs(jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(tk),
                                          jnp.asarray(tp)))
    got = ops.sampling_probs(_t(lg), _t(temps), _t(tk), _t(tp)).numpy()
    np.testing.assert_allclose(got, want, **PROB_TOL)


def test_disabled_top_p_masks_nothing_under_f32_rounding():
    """tests/test_sampling.py's case: all mass on one token rounds the f32
    exclusive cumulative mass to 1.0; top_p = 1.0 must still keep every
    token, so the masked graph equals the elided one (and JAX's)."""
    v = 1024
    logits = np.full(v, -14.0, np.float32)
    logits[0] = 10.0
    l2 = np.stack([logits, logits])
    temps = np.ones(2, np.float32)
    top_p = np.array([1.0, 0.9], np.float32)
    masked = ops.sampling_probs(_t(l2), _t(temps), _t(np.zeros(2, np.int32)), _t(top_p))
    elided = ops.sampling_probs(_t(l2), _t(temps), None, None)
    np.testing.assert_array_equal(masked[0].numpy(), elided[0].numpy())
    assert int((masked[0] > 0).sum()) == v
    want = np.asarray(jops.sampling_probs(jnp.asarray(l2), jnp.asarray(temps),
                                          jnp.zeros(2, jnp.int32), jnp.asarray(top_p)))
    np.testing.assert_allclose(masked.numpy(), want, **PROB_TOL)


# ------------------------------------------------------------- the draws
@pytest.mark.parametrize("v", [256, 1000, 128256])
def test_draws_match_jax(v):
    rng = np.random.default_rng(v)
    b = 16
    lg = _logits(rng, b, v)
    lg[:, v - 5:] = -1e30
    probs = np.asarray(jax.nn.softmax(jnp.asarray(lg), axis=-1))
    u = rng.random(b).astype(np.float32)
    want = np.asarray(jops._inverse_cdf(jnp.asarray(probs), jnp.asarray(u)))
    np.testing.assert_array_equal(ops._inverse_cdf(_t(probs), _t(u)).numpy(), want)
    seeds = rng.integers(0, 2**32, b)
    pos = rng.integers(0, 4096, b)
    keys = _keys_np(seeds.astype(np.uint32), pos.astype(np.int32), 0)
    want = np.asarray(jops.sample_from_probs(jnp.asarray(probs), jnp.asarray(keys, jnp.uint32)))
    np.testing.assert_array_equal(ops.sample_from_probs(_t(probs), _t(keys)).numpy(), want)
    temps = np.where(np.arange(b) % 4 == 0, 0.0, 0.8).astype(np.float32)
    tk = np.where(np.arange(b) % 2 == 0, 50, 0).astype(np.int32)
    tp = np.full(b, 0.95, np.float32)
    for k_arg, p_arg in ((tk, tp), (None, None)):
        want = np.asarray(jops.sample_tokens(
            jnp.asarray(lg), jnp.asarray(keys, jnp.uint32), jnp.asarray(temps),
            None if k_arg is None else jnp.asarray(k_arg),
            None if p_arg is None else jnp.asarray(p_arg)))
        got = ops.sample_tokens(_t(lg), _t(keys), _t(temps),
                                None if k_arg is None else _t(k_arg),
                                None if p_arg is None else _t(p_arg))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_rows_are_the_exact_argmax():
    rng = np.random.default_rng(2)
    lg = _logits(rng, 16, 128)
    keys = ops.sample_keys(torch.arange(16), torch.arange(16))
    toks = ops.sample_tokens(_t(lg), keys, torch.zeros(16), torch.full((16,), 3),
                             torch.full((16,), 0.5))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jnp.argmax(jnp.asarray(lg), -1)))


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype="float32")
    params = jT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _sampled(seed, new_tokens=6, temperature=0.8, top_k=0, top_p=0.95, **kw):
    return dict(temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
                max_new_tokens=new_tokens, **kw)


def _engines(models, **kw):
    """(JAX engine, port engine) built alike."""
    cfg, tcfg, jparams, tparams = models
    return JEngine(cfg, jparams, **kw), ServeEngine(tcfg, tparams, device="cpu", **kw)


def _serve_both(models, prompts, samplings, precisions, **kw):
    streams, stats = [], []
    for eng, samp_cls, prec_cls in zip(_engines(models, **kw), (JSampling, SamplingParams),
                                       (JPrecision, PrecisionParams)):
        reqs = [eng.submit(p, samp_cls(**s), prec_cls(w_bits=w, kv_bits=k))
                for p, s, (w, k) in zip(prompts, samplings, precisions)]
        eng.run()
        streams.append([r.out_tokens for r in reqs])
        stats.append(eng.stats)
    return streams, stats


def _prompts(seed, n, length, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length + i).astype(np.int32) for i in range(n)]


def test_sampled_streams_match_jax_over_mixed_precisions(models):
    """Six fixed-seed sampled requests, three slots, (w, kv) cycling over
    (4,8) (8,4) (16,16): temperature only, top_k, top_p and one greedy row
    share groups, so the masked and elided graphs meet in one call."""
    prompts = _prompts(3, 6, 9)
    samplings = [_sampled(11), _sampled(22, top_k=20, top_p=1.0), _sampled(33, top_p=0.9),
                 _sampled(44, temperature=1.2, top_p=1.0), _sampled(55, temperature=0.0),
                 _sampled(66, top_k=5)]
    precisions = [(4, 8), (8, 4), (16, 16)] * 2
    (j_out, t_out), (j_stats, t_stats) = _serve_both(
        models, prompts, samplings, precisions, max_slots=3, page_size=8, num_pages=32)
    assert t_out == j_out
    assert len(set(map(tuple, t_out))) == 6
    assert t_stats.mixed_precision_steps == j_stats.mixed_precision_steps > 0


def test_sampled_stream_is_independent_of_batch_composition(models):
    """One request decoded solo and batched with strangers: the same stream,
    and the JAX engine's."""
    prompts = _prompts(4, 3, 8)
    samplings = [_sampled(100 + i) for i in range(3)]
    (j_out, t_out), _ = _serve_both(models, prompts, samplings, [(8, 8)] * 3, max_slots=3,
                                    page_size=4, num_pages=64)
    assert t_out == j_out
    (_, solo), _ = _serve_both(models, prompts[1:2], samplings[1:2], [(8, 8)], max_slots=1,
                               page_size=4, num_pages=64)
    assert solo[0] == t_out[1]


def test_sampled_preemption_resumes_bit_equal(models):
    """A pool too small for the batch preempts and replays; the replayed
    requests redraw the uninterrupted streams (and the JAX engine's)."""
    prompts = _prompts(5, 3, 10)
    samplings = [_sampled(50 + i, new_tokens=8) for i in range(3)]
    (j_out, t_out), (j_stats, t_stats) = _serve_both(
        models, prompts, samplings, [(8, 8)] * 3, max_slots=3, page_size=4, num_pages=10)
    assert t_stats.preemptions == j_stats.preemptions > 0
    assert t_out == j_out
    (_, roomy), (_, r_stats) = _serve_both(models, prompts, samplings, [(8, 8)] * 3,
                                           max_slots=3, page_size=4, num_pages=64)
    assert r_stats.preemptions == 0 and roomy == t_out


def test_sampled_warm_prefix_matches_jax(models):
    """Followers of a shared system prompt adopt its cached pages and still
    draw the JAX engine's streams."""
    rng = np.random.default_rng(6)
    shared = rng.integers(0, 512, 19)
    prompts = [np.concatenate([shared, rng.integers(0, 512, 3 + i)]).astype(np.int32)
               for i in range(4)]
    samplings = [_sampled(7 + i, top_k=30) for i in range(4)]
    (j_out, t_out), (j_stats, t_stats) = _serve_both(
        models, prompts, samplings, [(8, 8), (4, 4)] * 2, max_slots=2, page_size=8,
        prefill_chunk=16, num_pages=32)
    assert t_stats.prefix_hit_tokens == j_stats.prefix_hit_tokens > 0
    assert t_out == j_out


def test_generate_event_contract_sampled(models):
    """generate() yields each token once, in order, the finish reason on
    the last event, then the terminal output; a stop token ends the stream
    with "stop"; the events equal the JAX engine's."""
    prompts = _prompts(8, 2, 8)
    jeng, teng = _engines(models, max_slots=4, page_size=4, num_pages=64)
    specs = [SamplingParams(max_new_tokens=5), SamplingParams(**_sampled(9, new_tokens=7))]
    jspecs = [JSampling(max_new_tokens=5), JSampling(**_sampled(9, new_tokens=7))]
    tev = list(teng.generate(list(zip(prompts, specs))))
    jev = list(jeng.generate(list(zip(prompts, jspecs))))
    strip = [(e.rid, e.token, e.index, e.finish_reason) for e in tev
             if isinstance(e, StreamEvent)]
    assert strip == [(e.rid, e.token, e.index, e.finish_reason) for e in jev
                     if not isinstance(e, JOutput)]
    outs = [e for e in tev if isinstance(e, GenerationOutput)]
    assert [(o.rid, o.tokens, o.finish_reason) for o in outs] == [
        (o.rid, o.tokens, o.finish_reason) for o in jev if isinstance(o, JOutput)]
    for o in outs:
        evs = [e for e in tev if isinstance(e, StreamEvent) and e.rid == o.rid]
        assert [e.index for e in evs] == list(range(len(o.tokens)))
        assert all(e.finish_reason is None for e in evs[:-1])
        assert evs[-1].finish_reason == o.finish_reason == "length"
    # stop on the third sampled token
    eos = outs[1].tokens[2]
    stopped = [e for e in ServeEngine(models[1], models[3], max_slots=4, page_size=4,
                                      num_pages=64, device="cpu").generate(
        [(prompts[1], SamplingParams(**_sampled(9, new_tokens=7, eos_id=eos)))])
        if isinstance(e, GenerationOutput)]
    assert stopped[0].finish_reason == "stop"
    assert list(stopped[0].tokens) == list(outs[1].tokens[: list(outs[1].tokens).index(eos) + 1])
