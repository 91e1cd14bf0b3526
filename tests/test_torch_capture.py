"""The port's capture-ready serving steps against the JAX package, on the CPU.

``serve/graphs.py`` captures each fixed-shape serving step as a CUDA graph
on the card.  What made the steps capturable is checked here, where every
step runs eagerly:

- the fixed-shape dropped scatter of the paged append
  (``decode.append_targets`` / ``scatter_rows``): bit-equal to JAX's
  ``mode="drop"`` scatter on the same values, for int4 / int8 payloads with
  their f32 scales and for bf16 payloads, where padding rows, rows past
  their ``n_draft`` and slots past the table width alias live rows'
  targets; and whole decode / chunk steps over such batches against JAX's
  ``paged_decode_step`` / ``chunk_prefill_step`` (logits within
  ``ATTN_TOL``; untouched pool entries bit-equal, written ones as in
  ``tests/test_torch_model.py``);
- the contiguous cache's device ``pos``: 12 ``decode_step`` calls on
  reduced zamba2-7b and mamba2-130m against JAX's (past ``max_len`` too,
  where both clamp the slab), and the waves' streams against the JAX
  ``Server``'s;
- the key of a captured step (:func:`graphs.step_key`): values share a key,
  shapes, precisions, ``spec_k`` and the sampling structure do not;
- eager equivalence: under ``disable_capture()`` the engine's greedy,
  sampled and speculative streams equal the JAX engine's, as without it.

Tolerances: logits ``ATTN_TOL`` (``tests/test_kernels_paged.py``'s 3e-3);
the contiguous cache as in ``tests/test_torch_waves.py`` (1e-4 of the
largest magnitude, int8 payloads one LSB apart in at most 1 of 1000).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro.serve import prefill as jprefill  # noqa: E402
from repro.train.server import Request as JRequest  # noqa: E402
from repro.train.server import Server as JServer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serve import decode, graphs, prefill  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402
from repro_torch.train.server import Request, Server  # noqa: E402

ATTN_TOL = dict(atol=3e-3, rtol=3e-3)  # tests/test_kernels_paged.py's
RTOL = 1e-4  # tests/test_torch_waves.py's


def _bits(a) -> np.ndarray:
    """A pool (torch or JAX) as its raw bits in numpy."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _pools(rng, shape, kv_bits, dtype=jnp.bfloat16):
    """(k, v, k_scale, v_scale) as numpy; scales None at 16 bits, where
    the payload is ``dtype`` and starts with -0.0 and extreme values."""
    if kv_bits < 16:
        pools = [rng.integers(-128, 128, shape).astype(np.int8) for _ in range(2)]
        return pools + [(rng.random((*shape[:-1], 1)) * 0.05).astype(np.float32)
                        for _ in range(2)]
    pools = [np.array(jnp.asarray(rng.normal(size=shape) * 50, dtype)) for _ in range(2)]
    pools[0].reshape(-1)[:3] = np.array(jnp.asarray([-0.0, 3e38, -1e-38], dtype))
    return pools + [None, None]


def _torch(a):
    return None if a is None else params_from_numpy({"x": a}, "cpu")["x"]


# ----------------------------------------------------- the dropped scatter
# decode: row 0 live at page 0 offset 0; row 1 live mid-page; row 2's slot
# lies past the table width; row 3 is past its n_draft (valid False) and
# aims at row 1's target; rows 4-5 are bucket padding (zero tables,
# length 0) and aim at row 0's target
DEC_TABLES = [[0, 5, 6], [1, 2, 3], [4, 7, 8], [9, 2, 0], [0, 0, 0], [0, 0, 0]]
DEC_LENGTHS = [0, 6, 12, 6, 0, 0]
DEC_VALID = [True, True, True, False, False, False]
# chunk (C = 5): row 0 positions 2-6; row 1 positions 9-13, of which 12-13
# lie past the width; row 2 positions 0-1 on page 0; row 3 is padding
# (q_len 0, zero table) aiming at page 0, where row 2 writes
CH_TABLES = [[3, 5, 6], [1, 2, 7], [0, 8, 9], [0, 0, 0]]
CH_START = [2, 9, 0, 0]
CH_LENS = [5, 5, 2, 0]
CH_C = 5


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_dropped_scatter_is_bit_equal_to_jax_drop(kv_bits, form):
    """The port's fixed-shape scatter against the JAX step's own
    ``mode="fill"`` page lookup and ``mode="drop"`` scatter
    (``repro/serve/decode.py`` / ``prefill.py``) on the same new values."""
    rng = np.random.default_rng(kv_bits + 100 * (form == "chunk"))
    n_layers, n_pages, ps, hkv, d = 3, 10, 4, 2, 8
    shape = (n_layers, n_pages, ps, hkv, d // 2 if kv_bits == 4 else d)
    pools = _pools(rng, shape, kv_bits)
    if form == "decode":
        tables, lengths, valid = (np.array(DEC_TABLES, np.int32), np.array(DEC_LENGTHS, np.int32),
                                  np.array(DEC_VALID))
        b = len(tables)
        rows = jnp.arange(b)
        ids = jnp.asarray(tables).at[rows, jnp.asarray(lengths) // ps].get(
            mode="fill", fill_value=n_pages)
        ids = jnp.where(jnp.asarray(valid), ids, n_pages)
        offs = jnp.asarray(lengths) % ps
        lead = (b,)
        targets = decode.append_targets(_torch(tables), _torch(lengths), _torch(valid), ps)
    else:
        tables, q_start, q_lens = (np.array(CH_TABLES, np.int32), np.array(CH_START, np.int32),
                                   np.array(CH_LENS, np.int32))
        b, c = len(tables), CH_C
        cpos = jnp.arange(c)
        posv = jnp.asarray(q_start)[:, None] + cpos[None, :]
        ids = jnp.asarray(tables).at[jnp.arange(b)[:, None], posv // ps].get(
            mode="fill", fill_value=n_pages)
        ids = jnp.where(cpos[None, :] < jnp.asarray(q_lens)[:, None], ids, n_pages)
        offs = posv % ps
        lead = (b, c)
        tpos = _torch(q_start)[:, None] + torch.arange(c, dtype=torch.int32)[None, :]
        tlive = torch.arange(c)[None, :] < _torch(q_lens)[:, None]
        targets = decode.append_targets(_torch(tables), tpos, tlive, ps)
    news = [None if p is None else
            (rng.integers(-128, 128, (n_layers, *lead, *p.shape[3:])).astype(np.int8)
             if p.dtype == np.int8 else
             np.asarray(jnp.asarray(rng.normal(size=(n_layers, *lead, *p.shape[3:])),
                                    jnp.asarray(p).dtype)))
            for p in pools]
    want = [None if p is None else
            jnp.asarray(p).at[:, ids, offs].set(jnp.asarray(n), mode="drop")
            for p, n in zip(pools, news)]
    ours = [_torch(p) for p in pools]
    decode.scatter_rows(ours, *targets, [None if n is None else _torch(n) for n in news])
    for w, o, p in zip(want, ours, pools):
        if p is None:
            continue
        np.testing.assert_array_equal(_bits(o), _bits(w))
        assert (_bits(o) != _bits(p)).any()  # the live rows did write


def _step_setup(kv_bits, seed):
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32",
                              serve_kv_bits=kv_bits)
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype="float32",
                               serve_kv_bits=kv_bits)
    params = jT.quantize_params(jT.init_params(cfg, jax.random.PRNGKey(seed)), 8)
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 10, 4, cfg.n_kv_heads, cfg.hd // 2 if kv_bits == 4 else cfg.hd)
    return cfg, tcfg, params, ours, _pools(rng, shape, kv_bits, jnp.float32), rng


def _check_step_pools(jpools, tpools, pools, kv_bits):
    """Entries the JAX step left alone are bit-equal in the port's pools
    too, and the port wrote exactly the entries JAX wrote: int payloads one
    LSB apart at most (an f32 sum on the other side of a rounding
    boundary; a packed int4 byte holds two such nibbles), the rest within
    float32 summation-order error."""
    for jp, tp, p in zip(jpools, tpools, pools):
        if p is None:
            continue
        ja, ta, pa = _bits(jp), _bits(tp), _bits(p)
        touched = (ja != pa).reshape(*ja.shape[:3], -1).any(-1)
        np.testing.assert_array_equal(ta[~touched], ja[~touched])
        assert ((ta != pa).reshape(*ta.shape[:3], -1).any(-1) <= touched).all()
        got, exp = np.asarray(tp.float()), np.asarray(jnp.asarray(jp).astype(jnp.float32))
        if p.dtype == np.int8 and kv_bits == 4:
            lo = lambda a: ((a.astype(np.int8) << 4).astype(np.int8) >> 4)  # noqa: E731
            for f in (lo, lambda a: a.astype(np.int8) >> 4):
                assert np.abs(f(ta).astype(int) - f(ja).astype(int)).max() <= 1
        elif p.dtype == np.int8:
            assert np.abs(got - exp).max() <= 1
        else:
            np.testing.assert_allclose(got, exp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_decode_step_with_dropped_rows_matches_jax(kv_bits):
    cfg, tcfg, params, ours, pools, rng = _step_setup(kv_bits, 7 + kv_bits)
    tables, lengths, valid = (np.array(DEC_TABLES, np.int32), np.array(DEC_LENGTHS, np.int32),
                              np.array(DEC_VALID))
    tokens = rng.integers(0, cfg.vocab, (len(tables), 1)).astype(np.int32)
    step = jax.jit(jdecode.paged_decode_step, static_argnames=("cfg",))
    jlog, jpools = step(params, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(tables),
                        jnp.asarray(valid), *[None if p is None else jnp.asarray(p)
                                              for p in pools], cfg=cfg)
    tpools = [_torch(p) for p in pools]
    tlog, _ = decode.paged_decode_step(ours, _torch(tokens), _torch(lengths), _torch(tables),
                                       _torch(valid), *tpools, cfg=tcfg)
    np.testing.assert_allclose(tlog.numpy()[:, :cfg.vocab], np.asarray(jlog)[:, :cfg.vocab],
                               **ATTN_TOL)
    _check_step_pools(jpools, tpools, pools, kv_bits)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_chunk_step_with_dropped_rows_matches_jax(kv_bits):
    cfg, tcfg, params, ours, pools, rng = _step_setup(kv_bits, 11 + kv_bits)
    tables, q_start, q_lens = (np.array(CH_TABLES, np.int32), np.array(CH_START, np.int32),
                               np.array(CH_LENS, np.int32))
    tokens = rng.integers(0, cfg.vocab, (len(tables), CH_C)).astype(np.int32)
    step = jax.jit(jprefill.chunk_prefill_step, static_argnames=("cfg",))
    jlog, jpools = step(params, jnp.asarray(tokens), jnp.asarray(q_start), jnp.asarray(q_lens),
                        jnp.asarray(tables), *[None if p is None else jnp.asarray(p)
                                               for p in pools], cfg=cfg)
    tpools = [_torch(p) for p in pools]
    tlog, _ = prefill.chunk_prefill_step(ours, _torch(tokens), _torch(q_start), _torch(q_lens),
                                         _torch(tables), *tpools, cfg=tcfg)
    live = q_lens > 0  # a padding row's logits are unused
    np.testing.assert_allclose(tlog.numpy()[live, :cfg.vocab],
                               np.asarray(jlog)[live, :cfg.vocab], **ATTN_TOL)
    _check_step_pools(jpools, tpools, pools, kv_bits)


# --------------------------------------------- the contiguous cache's pos
_jprefill = jax.jit(jT.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(jT.decode_step, static_argnames=("cfg",))


def _wave_cfgs(name, **kw):
    over = dict(dtype="float32", **kw)
    return (dataclasses.replace(get_config(name).reduced(), **over),
            dataclasses.replace(tget(name).reduced(), **over))


def _close_rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert np.abs(got - exp).max() <= RTOL * max(np.abs(exp).max(), 1e-30)


def _check_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    assert int(tcache["pos"]) == int(jcache["pos"])
    for name, jv in jcache.items():
        if name == "pos":
            continue
        got, exp = tcache[name].numpy(), np.asarray(jv)
        if got.dtype == np.int8:
            off = got.astype(np.int32) != exp
            assert np.abs(got.astype(np.int32) - exp).max() <= 1, name
            assert off.mean() <= 1e-3, (name, int(off.sum()), off.size)
        else:
            _close_rel(got, exp)


@pytest.mark.parametrize("w_bits,kv_bits", [(8, 8), (16, 16)])
@pytest.mark.parametrize("name", ["zamba2-7b", "mamba2-130m"])
def test_decode_step_with_a_device_pos_matches_jax(name, w_bits, kv_bits):
    """12 steps from an 11-token prompt into a cache of 16: the last steps
    write past ``max_len``, where the slab clamps as JAX's
    ``dynamic_update_slice`` does.  16-bit: the port's own cache throughout;
    8-bit: each step from the JAX cache carried over (a payload one LSB off
    would move later steps), while ``pos`` advances in place."""
    cfg, tcfg = _wave_cfgs(name, serve_kv_bits=kv_bits)
    params = jT.init_params(cfg, jax.random.PRNGKey(3))
    if w_bits < 16:
        params = jT.quantize_params(params, w_bits)
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    _, jcache = _jprefill(params, {"tokens": jnp.asarray(tokens)}, cfg=cfg, max_len=16)
    _, tcache = tT.prefill(ours, {"tokens": torch.from_numpy(tokens)}, tcfg, 16)
    pos = tcache["pos"]
    for i in range(12):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        if kv_bits < 16:
            tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
            pos = tcache["pos"]
        jlog, jcache = _jdecode(params, jnp.asarray(tok), jcache, cfg=cfg)
        tlog, out = tT.decode_step(ours, torch.from_numpy(tok), tcache, tcfg)
        assert out is tcache and out["pos"] is pos and int(pos) == 12 + i
        _close_rel(tlog.numpy()[:, :cfg.vocab], np.asarray(jlog)[:, :cfg.vocab])
        _check_cache(tcache, jcache)


def _wave_streams(server_cls, request_cls, cfg, params, prompts, **kw):
    srv = server_cls(cfg, params, batch_size=4, max_len=24, **kw)
    out = []
    for _ in range(2):  # twice through one Server: its wave caches are reused
        reqs = [request_cls(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(prompts)]
        srv.serve(reqs)
        out.append([list(r.out_tokens) for r in reqs])
    return out, srv


@pytest.mark.parametrize("name", ["zamba2-7b", "mamba2-130m"])
def test_waves_with_a_device_pos_match_the_jax_server(name):
    """6 requests in waves of 4 and 2 (two wave sizes, so two captured-step
    keys and two caches), ragged prompts and budgets, served twice by one
    Server, also under ``disable_capture()``: the JAX Server's streams."""
    cfg, tcfg = _wave_cfgs(name)
    params = jT.init_params(cfg, jax.random.PRNGKey(6))
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(6)
    prompts = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
               for n, m in ((7, 5), (4, 3), (6, 6), (9, 2), (5, 4), (3, 7))]
    (theirs, _), _ = _wave_streams(JServer, JRequest, cfg, params, prompts)
    mine, srv = _wave_streams(Server, Request, tcfg, ours, prompts, device="cpu")
    assert mine == [theirs, theirs]
    assert sorted(srv._caches) == [2, 4]
    # one key per wave size, called once per decode step: 2 x 6 and 2 x 7
    assert sorted(srv.graphs.calls.values()) == [12, 14]
    with graphs.disable_capture():
        eager, _ = _wave_streams(Server, Request, tcfg, ours, prompts, device="cpu")
    assert eager == mine


# ------------------------------------------------------------------ the key
def _key(step="decode", kv_bits=8, static=(8,), b=4, w=8, c=None, samp="greedy", seed=0):
    cfg = dataclasses.replace(tget("llama3.2-3b").reduced(), serve_kv_bits=kv_bits)
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 99, (b, w)), rng.integers(0, 99, (b, c or 1)),
              rng.integers(0, 99, b), rng.integers(0, 2, b)]
    flat, shapes = graphs.pack(arrays)
    host = None if samp == "greedy" else torch.from_numpy(rng.random((5, b)))
    kind = {"greedy": None, "temperature": (False, False), "top_k": (True, False),
            "top_p": (False, True)}[samp]
    return graphs.step_key(step, cfg, (*static, shapes, kind), (torch.from_numpy(flat), host))


def test_step_key_shares_values_and_splits_shapes_precisions_and_structure():
    base = _key()
    assert _key(seed=1) == base  # other values, the same program
    assert _key(samp="top_k", seed=1) == _key(samp="top_k", seed=2)
    others = [_key(b=8), _key(w=16), _key(c=4, step="chunk"), _key(kv_bits=4),
              _key(static=(4,)), _key(step="spec", static=(8, 4, 4)),
              _key(samp="temperature"), _key(samp="top_k"), _key(samp="top_p")]
    assert len({base, *others}) == len(others) + 1
    assert _key(c=4, step="chunk") != _key(c=8, step="chunk")
    assert _key(step="spec", static=(8, 4, 4)) != _key(step="spec", static=(8, 4, 2))
    assert _key(step="spec", static=(8, 4, 4)) != _key(step="spec", static=(8, 8, 4))


def test_pack_unpack_round_trip_contiguous_views():
    arrays = [np.arange(12).reshape(3, 4), np.array([[5], [6], [7]]), np.array([True, False, True])]
    flat, shapes = graphs.pack(arrays)
    views = graphs.unpack(torch.from_numpy(flat), shapes)
    assert shapes == ((3, 4), (3, 1), (3,))
    for v, a in zip(views, arrays):
        assert v.is_contiguous() and v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), a.astype(np.int32))


# ------------------------------------------------------- eager equivalence
@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype="float32")
    params = jT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


TRAFFIC = {
    "greedy": (lambda i: {}, lambda i: [(4, 8), (8, 4), (16, 16)][i % 3], {}),
    "sampled": (lambda i: {"temperature": 0.8, "top_p": 0.9, "top_k": 20 if i % 2 else 0,
                           "seed": i}, lambda i: [(8, 8), (4, 4)][i % 2], {}),
    "spec": (lambda i: {}, lambda i: (8, 8), {"spec_k": 3, "draft_bits": 4}),
    "spec_sampled": (lambda i: {"temperature": 0.8, "seed": i}, lambda i: (8, 8),
                     {"spec_k": 3, "draft_bits": 4}),
}


def _engine_streams(engine_cls, samp_cls, prec_cls, cfg, params, kind, **kw):
    sampling, precision, spec = TRAFFIC[kind]
    eng = engine_cls(cfg, params, max_slots=3, page_size=8, prefill_chunk=16, num_pages=40,
                     **spec, **kw)
    rng = np.random.default_rng(9)
    reqs = [eng.submit(rng.integers(0, 512, 9 + 3 * i).astype(np.int32),
                       samp_cls(max_new_tokens=7, **sampling(i)),
                       prec_cls(**dict(zip(("w_bits", "kv_bits"), precision(i)))))
            for i in range(5)]
    eng.run()
    return [list(r.out_tokens) for r in reqs], eng


@pytest.mark.parametrize("kind", list(TRAFFIC))
def test_engine_streams_under_disable_capture_equal_jax(models, kind):
    cfg, tcfg, jparams, tparams = models
    theirs, _ = _engine_streams(JEngine, JSampling, JPrecision, cfg, jparams, kind)
    mine, eng = _engine_streams(ServeEngine, SamplingParams, PrecisionParams, tcfg, tparams,
                                kind, device="cpu")
    with graphs.disable_capture():
        eager, _ = _engine_streams(ServeEngine, SamplingParams, PrecisionParams, tcfg, tparams,
                                   kind, device="cpu")
    assert mine == eager == theirs
    # every group call went through the step cache; a key's later calls
    # differ in values only, as a JAX jit's do
    steps = {key[0] for key in eng.graphs.calls}
    assert {"chunk", "spec" if "spec" in kind else "decode"} <= steps
    assert max(eng.graphs.calls.values()) > 1
    assert eng.graphs.captured == 0  # nothing is captured on the CPU
