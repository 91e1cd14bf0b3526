"""The port's self-speculative decoding against the JAX package's.

``rejection_sample`` gives JAX's (tokens, accept) on identical inputs, with
greedy one-hots and with sampled distributions; ``plan_windows`` and
``clip_stop`` give JAX's results; ``paged_verify_attention`` agrees with
JAX's within the reference's attention tolerance (3e-3).  On the float32
reduced llama3.2-3b of tests/test_torch_engine.py (weights carried over
with params_from_numpy), greedy spec-on streams equal spec-off streams and
the JAX engine's, with JAX's spec counters, over kv 4/8/16, (w, draft) in
{(4,4), (8,8), (16,8)}, forced preemption, a warm prefix start, a stop
token inside a window and the budget clip; a fixed-seed sampled spec
stream equals JAX's.  Last, the serving CLI with the sampling and spec
flags on the CPU, whose report has the JAX launcher's keys plus
``device``."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.quant.pack import pack_int4 as jpack_int4  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import ServeRequest as JRequest  # noqa: E402
from repro.serve import spec_decode as jspec  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import spec_decode as tspec  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402
from repro_torch.serve.request import ServeRequest  # noqa: E402

ATTN_TOL = dict(atol=3e-3, rtol=3e-3)  # tests/test_kernels_paged.py's


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ------------------------------------------------------ rejection sampling
def _both_reject(drafts, qd, qt, seeds, pos0, n_draft):
    jt, ja = jspec.rejection_sample(
        jnp.asarray(drafts, jnp.int32), jnp.asarray(qd), jnp.asarray(qt),
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(pos0, jnp.int32),
        jnp.asarray(n_draft, jnp.int32))
    tt, ta = tspec.rejection_sample(_t(drafts), _t(qd), _t(qt), _t(seeds.astype(np.int64)),
                                    _t(pos0), _t(n_draft))
    return (np.asarray(jt), np.asarray(ja)), (tt.numpy(), ta.numpy())


@pytest.mark.parametrize("n_match", [0, 1, 2, 3])
def test_rejection_sample_greedy_onehots_match_jax(n_match):
    v, k = 8, 3
    tgt = np.array([2, 5, 1, 4])
    drafts = np.array([[tgt[i] if i < n_match else (tgt[i] + 1) % v for i in range(k)]])
    qd = np.zeros((1, k, v), np.float32)
    qd[0, np.arange(k), drafts[0]] = 1.0
    qt = np.zeros((1, k + 1, v), np.float32)
    qt[0, np.arange(k + 1), tgt] = 1.0
    (jt, ja), (tt, ta) = _both_reject(drafts, qd, qt, np.array([123]), np.array([0]),
                                      np.array([k]))
    assert ta.tolist() == ja.tolist() == [n_match]
    np.testing.assert_array_equal(tt, jt)
    assert tt[0, : n_match + 1].tolist() == tgt[: n_match + 1].tolist()


@pytest.mark.parametrize("k", [1, 4])
def test_rejection_sample_sampled_matches_jax(k):
    """Random draft and target distributions, n_draft from 0 to k, drafts
    drawn from the draft distribution (so some are accepted)."""
    rng = np.random.default_rng(k)
    b, v = 32, 64
    qd = rng.random((b, k, v)).astype(np.float32) ** 4
    qd /= qd.sum(-1, keepdims=True)
    qt = (0.5 * np.concatenate([qd, qd[:, :1]], axis=1)
          + 0.5 * rng.random((b, k + 1, v)).astype(np.float32) ** 4)
    qt /= qt.sum(-1, keepdims=True)
    qt[:, :, v - 4:] = 0.0  # tokens the target never emits
    drafts = np.stack([[rng.choice(v, p=qd[i, j] / qd[i, j].sum()) for j in range(k)]
                       for i in range(b)])
    seeds = rng.integers(0, 2**32, b)
    pos0 = rng.integers(0, 1000, b)
    n_draft = rng.integers(0, k + 1, b)
    (jt, ja), (tt, ta) = _both_reject(drafts, qd, qt, seeds, pos0, n_draft)
    np.testing.assert_array_equal(ta, ja)
    assert (ta <= n_draft).all() and 0 < ta.sum() < n_draft.sum()
    np.testing.assert_array_equal(tt, jt)


# ---------------------------------------------------------- window helpers
def _req(cls, **kw):
    return cls(rid=0, prompt=np.arange(4, dtype=np.int32), **kw)


def test_plan_windows_and_clip_stop_match_jax():
    cases = [dict(max_new_tokens=10, spec_k=4, out=[1], cache=20),
             dict(max_new_tokens=3, spec_k=4, out=[1, 2], cache=20),   # budget clip
             dict(max_new_tokens=10, spec_k=2, out=[1], cache=29),     # page room
             dict(max_new_tokens=10, spec_k=6, out=[1], cache=31),     # no room at all
             dict(max_new_tokens=1, spec_k=3, out=[5], cache=8)]
    caps = np.array([32, 32, 32, 32, 16], np.int64)
    reqs = {}
    for cls in (JRequest, ServeRequest):
        reqs[cls] = []
        for c in cases:
            r = _req(cls, max_new_tokens=c["max_new_tokens"], spec_k=c["spec_k"],
                     eos_id=7, stop_tokens=(9,))
            r.out_tokens, r.cache_len = list(c["out"]), c["cache"]
            reqs[cls].append(r)
    for spec_k in (3, 5):
        want = jspec.plan_windows(reqs[JRequest], caps, spec_k)
        np.testing.assert_array_equal(tspec.plan_windows(reqs[ServeRequest], caps, spec_k), want)
    for emitted in ([1, 2, 3], [1, 7, 3], [9], [7, 9, 2], []):
        assert (tspec.clip_stop(reqs[ServeRequest][0], list(emitted))
                == jspec.clip_stop(reqs[JRequest][0], list(emitted)))


# -------------------------------------------------------- verify attention
def _payload(rng, shape, kv_bits):
    if kv_bits == 16:
        return rng.normal(size=shape).astype(np.float32), None
    lim = 8 if kv_bits == 4 else 128
    x = rng.integers(-lim, lim, shape).astype(np.int8)
    s = (rng.random((*shape[:-1], 1)) * 0.1).astype(np.float32)
    if kv_bits == 4:
        x = np.asarray(jpack_int4(jnp.asarray(x), axis=-1))
    return x, s


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_paged_verify_attention_matches_jax(kv_bits):
    """A verify window: C = spec_k + 1 = 5, q_lens = n_draft + 1 from 1 to
    5 and 0 on a padding row, at the round-start contexts."""
    rng = np.random.default_rng(kv_bits)
    b, c, hkv, groups, d, ps, w, n_layers, layer = 4, 5, 2, 3, 32, 4, 6, 2, 1
    n_pages = b * w + 1
    kp, ks = _payload(rng, (n_layers, n_pages, ps, hkv, d), kv_bits)
    vp, vs = _payload(rng, (n_layers, n_pages, ps, hkv, d), kv_bits)
    ck, cks = _payload(rng, (b, c, hkv, d), kv_bits)
    cv, cvs = _payload(rng, (b, c, hkv, d), kv_bits)
    q = rng.normal(size=(b, c, hkv * groups, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([9, 0, 17, 3], np.int32)
    q_lens = np.array([5, 1, 3, 0], np.int32)
    args = (q, kp, vp, tables, ctx, q_lens, layer, ck, cv)
    kw = dict(k_scale=ks, v_scale=vs, chunk_k_scale=cks, chunk_v_scale=cvs)
    got = tattn.paged_verify_attention(
        *(_t(a) if isinstance(a, np.ndarray) else a for a in args),
        **{k: _t(v) for k, v in kw.items()}, kv_bits=kv_bits).numpy()
    want = np.asarray(jattn.paged_verify_attention(
        *(_j(a) if isinstance(a, np.ndarray) else a for a in args),
        **{k: _j(v) for k, v in kw.items()}, kv_bits=kv_bits))
    live = np.arange(c)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(got[live], want[live], **ATTN_TOL)
    want_pallas = np.asarray(jops.paged_mqa_verify(
        _j(q), _j(kp), _j(vp), _j(ks), _j(vs), _j(tables), _j(ctx), _j(q_lens), layer,
        _j(ck), _j(cv), _j(cks), _j(cvs), kv_bits=kv_bits, backend="pallas",
        interpret=True))
    np.testing.assert_allclose(got[live], want_pallas[live], **ATTN_TOL)


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype="float32")
    params = jT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


SPEC_STATS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens", "preemptions",
              "prefix_hit_tokens", "tokens_out")


def _run(models, port, prompts, new_tokens=8, spec_k=0, num_pages=64, prefill_chunk=16,
         sampling=None, precision=None, **kw):
    """One engine run (the JAX one, or the port's with ``port``); returns
    (engine, requests)."""
    cfg, tcfg, jparams, tparams = models
    if port:
        eng = ServeEngine(tcfg, tparams, max_slots=len(prompts), num_pages=num_pages,
                          page_size=4, prefill_chunk=prefill_chunk, spec_k=spec_k,
                          device="cpu", **kw)
        samp_cls, prec_cls = SamplingParams, PrecisionParams
    else:
        eng = JEngine(cfg, jparams, max_slots=len(prompts), num_pages=num_pages, page_size=4,
                      prefill_chunk=prefill_chunk, spec_k=spec_k, **kw)
        samp_cls, prec_cls = JSampling, JPrecision
    samps = sampling or [dict(max_new_tokens=new_tokens)] * len(prompts)
    precs = precision or [dict(w_bits=8, kv_bits=8)] * len(prompts)
    reqs = [eng.submit(p, samp_cls(**s), prec_cls(**pr)) for p, s, pr in zip(prompts, samps, precs)]
    eng.run()
    return eng, reqs


def _check_spec(models, prompts, **kw):
    """Port spec-on == port spec-off == JAX spec-on, with JAX's counters;
    returns the port's spec engine."""
    spec_k = kw.pop("spec_k")
    _, plain = _run(models, True, prompts, **kw)
    jeng, jreqs = _run(models, False, prompts, spec_k=spec_k, **kw)
    teng, treqs = _run(models, True, prompts, spec_k=spec_k, **kw)
    streams = [r.out_tokens for r in treqs]
    assert streams == [r.out_tokens for r in plain]
    assert streams == [r.out_tokens for r in jreqs]
    for name in SPEC_STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert [(r.spec_drafted, r.spec_accepted, r.finish_reason) for r in treqs] == [
        (r.spec_drafted, r.spec_accepted, r.finish_reason) for r in jreqs]
    return teng, treqs


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, length).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_spec_greedy_equals_plain_and_jax(models, kv_bits):
    w_bits = 16 if kv_bits == 16 else 8
    prec = [dict(w_bits=w_bits, kv_bits=kv_bits, draft_bits=4)] * 3
    eng, reqs = _check_spec(models, _prompts(0, 3, 9), spec_k=3, precision=prec)
    assert all(len(r.out_tokens) == 8 for r in reqs) and eng.stats.spec_rounds > 0
    assert eng.cache_for(kv_bits).num_allocatable == 64  # every tail rolled back


@pytest.mark.parametrize("w_bits,draft_bits", [(4, 4), (8, 8), (16, 8)])
def test_spec_greedy_across_weight_precisions(models, w_bits, draft_bits):
    kv = 16 if w_bits == 16 else 8
    prec = [dict(w_bits=w_bits, kv_bits=kv, draft_bits=draft_bits)] * 2
    eng, _ = _check_spec(models, _prompts(1, 2, 7), spec_k=4, precision=prec)
    assert eng.stats.spec_rounds > 0
    if draft_bits == w_bits:  # the draft is the target: every draft accepted
        assert eng.stats.spec_accept_rate == 1.0


def test_spec_greedy_under_forced_preemption(models):
    eng, _ = _check_spec(models, _prompts(3, 3, 10), spec_k=3, num_pages=10)
    assert eng.stats.preemptions > 0 and eng.stats.spec_rounds > 0
    assert eng.cache_for(8).num_allocatable == 10


def test_spec_greedy_warm_prefix_start(models):
    """The second request adopts the first's cached system prompt, then
    speculates: the same stream as a cold spec-off run, and as JAX."""
    rng = np.random.default_rng(4)
    sys_prompt = rng.integers(0, 512, 12).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, 512, 5).astype(np.int32)])
               for _ in range(2)]
    streams = {}
    for port in (False, True):
        cfg, tcfg, jparams, tparams = models
        eng = (ServeEngine(tcfg, tparams, max_slots=2, num_pages=64, page_size=4,
                           prefill_chunk=8, spec_k=3, device="cpu") if port else
               JEngine(cfg, jparams, max_slots=2, num_pages=64, page_size=4, prefill_chunk=8,
                       spec_k=3))
        samp, prec = (SamplingParams, PrecisionParams) if port else (JSampling, JPrecision)
        out = []
        for p in prompts:
            r = eng.submit(p, samp(max_new_tokens=6), prec(w_bits=8, kv_bits=8))
            eng.run()
            out.append(r.out_tokens)
        assert eng.stats.prefix_hit_tokens >= 12
        streams[port] = (out, eng.stats.spec_accepted_tokens)
    assert streams[True] == streams[False]
    for i, p in enumerate(prompts):
        _, (cold,) = _run(models, True, [p], new_tokens=6, enable_prefix_cache=False)
        assert streams[True][0][i] == cold.out_tokens


@pytest.mark.parametrize("pos", [2, 4, 6])
def test_spec_eos_inside_a_window(models, pos):
    prompts = _prompts(9, 1, 8)
    _, (ref,) = _run(models, True, prompts)
    eos = ref.out_tokens[pos]
    samp = [dict(max_new_tokens=8, eos_id=eos)]
    prec = [dict(w_bits=8, kv_bits=8, draft_bits=8)]
    eng, (req,) = _check_spec(models, prompts, spec_k=3, sampling=samp, precision=prec)
    first = ref.out_tokens.index(eos)  # may come earlier, even from prefill
    assert req.out_tokens == ref.out_tokens[: first + 1]
    assert req.finish_reason == "stop" and (eng.stats.spec_rounds > 0) == (first > 0)
    assert eng.cache_for(8).num_allocatable == 64


@pytest.mark.parametrize("budget", [1, 2, 5, 7])
def test_spec_budget_clip(models, budget):
    """A budget that is no multiple of the round: the last window is clipped
    (at budgets 1 and 2 no window is left, and no round runs)."""
    prec = [dict(w_bits=8, kv_bits=8, draft_bits=8)]
    eng, (req,) = _check_spec(models, _prompts(5, 1, 6), spec_k=3, new_tokens=budget,
                              precision=prec)
    assert len(req.out_tokens) == budget
    assert (eng.stats.spec_rounds > 0) == (budget > 2)


def test_spec_sampled_stream_matches_jax(models):
    """Sampled speculation (rejection sampling) under fixed seeds: the port
    emits the JAX engine's streams, round for round, and again on a rerun."""
    prompts = _prompts(7, 2, 12)
    samp = [dict(temperature=0.8, top_p=0.95, seed=70 + i, max_new_tokens=8) for i in range(2)]
    samp[1]["top_k"] = 40
    prec = [dict(w_bits=8, kv_bits=8, draft_bits=4)] * 2
    jeng, jreqs = _run(models, False, prompts, spec_k=3, sampling=samp, precision=prec)
    teng, treqs = _run(models, True, prompts, spec_k=3, sampling=samp, precision=prec)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    for name in SPEC_STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.stats.spec_rounds > 0 and teng.stats.spec_draft_tokens > 0
    _, again = _run(models, True, prompts, spec_k=3, sampling=samp, precision=prec)
    assert [r.out_tokens for r in again] == [r.out_tokens for r in treqs]


def test_engine_refuses_bad_draft_bits(models):
    with pytest.raises(ValueError, match="draft_bits"):
        ServeEngine(models[1], models[3], draft_bits=2, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(models[1], models[3], spec_k=-1, device="cpu")


# ---------------------------------------------------------------- launcher
def test_launch_serve_sampled_spec_on_the_cpu():
    argv = ["--arch", "llama3.2-3b", "--reduced", "--requests", "3", "--prompt-len", "10",
            "--new-tokens", "5", "--batch-size", "2", "--page-size", "4",
            "--temperature", "0.8", "--top-p", "0.9", "--spec-k", "2", "--draft-bits", "8"]
    report = tserve.main([*argv, "--device", "cpu"])
    with redirect_stdout(io.StringIO()) as out:
        want = jserve.main(argv)
    assert json.loads(out.getvalue()) == want
    assert set(report) == set(want) | {"device"}
    assert report["device"] == "cpu"
    assert report["tokens_out"] == report["stream_events"] == 15
    assert report["spec_k"] == 2 and report["spec_rounds"] > 0
    assert 0.0 <= report["spec_accept_rate"] <= 1.0
    assert report["temperature"] == 0.8 and report["top_p"] == 0.9
    assert report["finish_reasons"] == ["length"] * 3
