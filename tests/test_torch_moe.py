"""The port's MoE family against the JAX package: ``models/moe.py``'s routing
and dispatch, ``moe_ffn``, MoE parameters and their quantization, reduced
mixtral-8x22b through the paged ``ServeEngine`` (greedy and speculative
streams), reduced kimi-k2-1t-a32b (MoE after one dense block) through the
static-wave ``Server``, and the launcher for both.

Tolerances: expert ids, each assignment's slot in its expert and the dropped
assignments are bit-exact.  The gate weights agree within 1e-6 relative, not
bit for bit: XLA's and PyTorch's f32 ``exp`` differ in their last bit, so the
softmax does too, even where the router logits are exactly equal.
``moe_ffn`` with f32 experts within atol = rtol = 1e-5 (the frameworks sum
the products in other orders); with W4/W8 experts in f32, and with bf16
experts in bf16, within 2e-3 (tests/test_kernels_mpmm.py's mpmm tolerance)
of the output's largest magnitude.  W4/W8 experts in bf16 need more, 2^-6
(two bf16 steps at the output's largest magnitude; measured up to 8.5e-3):
the JAX ``_deq`` rounds each ``w * scale`` to bf16 (2^-9 relative) before
the product, where the port, as the CF kernel does, scales the f32 sum, and
gate, up and their product are each rounded to bf16 between the three
products.  Greedy float32 streams are token-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train.server import Request as JRequest  # noqa: E402
from repro.train.server import Server as JServer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402
from repro_torch.train.server import Request, Server, engine_family  # noqa: E402


def _cfgs(name, **over):
    over = dict(dtype="float32", **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    tcfg = dataclasses.replace(tget(name).reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    return cfg, tcfg


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _model(name, seed):
    cfg, tcfg = _cfgs(name)
    params = jT.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, params, _carry(params)


@pytest.fixture(scope="module")
def mixtral():
    return _model("mixtral-8x22b", 0)


@pytest.fixture(scope="module")
def kimi():
    return _model("kimi-k2-1t-a32b", 6)


# ------------------------------------------------------------ routing
# (T tokens, router scale, skew): the reduced mixtral shape (D 128, E 8,
# top-2) at a decode batch (cap 2) and at a prefill chunk, and a router
# skewed towards expert 0 so that its capacity binds
ROUTE_CASES = [(8, 1.0, 0.0), (64, 1.0, 0.0), (48, 1.0, 4.0)]


def _route_inputs(t, scale, skew):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(t, 128)).astype(np.float32)
    router = (rng.normal(size=(128, 8)) * scale / np.sqrt(128)).astype(np.float32)
    router[:, 0] += skew * np.sign(x.mean(0)) / 128  # favour expert 0
    return x, router


@pytest.mark.parametrize("t,scale,skew", ROUTE_CASES)
def test_route_and_dispatch_match_jax(t, scale, skew):
    x, router = _route_inputs(t, scale, skew)
    jw, je, jaux, jprobs = jmoe._route(jnp.asarray(x), jnp.asarray(router), 2)
    tw, te, taux, tprobs = tmoe._route(torch.from_numpy(x), torch.from_numpy(router), 2)
    assert te.dtype == torch.int32 and np.array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    jpos = np.asarray(jmoe._positions_in_expert(je.reshape(-1), 8))
    tpos = tmoe._positions_in_expert(te.reshape(-1), 8)
    assert tpos.dtype == torch.int32 and np.array_equal(tpos.numpy(), jpos)
    cap = int(max(1, (t * 2 * 1.25) // 8))
    dropped = int((jpos >= cap).sum())
    assert dropped > 0 or not skew  # the skewed router overflows expert 0


@pytest.mark.parametrize("n", [1, 7, 40])
def test_positions_in_expert_are_stable_ranks(n):
    rng = np.random.default_rng(n)
    eids = rng.integers(0, 4, n)
    pos = tmoe._positions_in_expert(torch.from_numpy(eids), 4).numpy()
    want = [int((eids[:i] == e).sum()) for i, e in enumerate(eids)]
    assert pos.tolist() == want
    assert np.array_equal(pos, np.asarray(jmoe._positions_in_expert(jnp.asarray(eids), 4)))


# ------------------------------------------------------------ moe_ffn
def _moe_params(dtype, bits, seed=0):
    params = jmoe.init_moe_params(jax.random.PRNGKey(seed), 128, 256, 8, jnp.dtype(dtype))
    if bits < 16:
        params = jT.quantize_params({"moe": params}, bits)["moe"]
    return params


@pytest.mark.parametrize("dtype,bits,tol", [
    ("float32", 16, 1e-5), ("float32", 8, 2e-3), ("float32", 4, 2e-3),
    ("bfloat16", 16, 2e-3), ("bfloat16", 8, 2 ** -6), ("bfloat16", 4, 2 ** -6),
])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_jax(dtype, bits, tol, capacity_factor):
    """[2, 24, 128] tokens, reduced mixtral's experts (8 x 128 x 256, top-2);
    at capacity factor 0.5 a third of the assignments drop."""
    params = _moe_params(dtype, bits)
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(2, 24, 128)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jout, jaux = jmoe.moe_ffn(jx, params, top_k=2, capacity_factor=capacity_factor)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tout, taux = tmoe.moe_ffn(tx, _carry(params), top_k=2, capacity_factor=capacity_factor)
    assert tout.dtype == tx.dtype and tout.shape == (2, 24, 128)
    got, exp = tout.float().numpy(), np.asarray(jout.astype(jnp.float32))
    if bits == 16 and dtype == "float32":
        np.testing.assert_allclose(got, exp, atol=tol, rtol=tol)
    else:
        assert np.abs(got - exp).max() <= tol * np.abs(exp).max()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_quantized_experts_run_through_mpmm_one_expert_at_a_time(monkeypatch):
    """W4/W8 experts: three ``ops.mpmm`` calls per expert, each on that
    expert's [cap, K] buffer and its own packed payload; no dequantized
    weight is made.  Unquantized experts take no ``ops.mpmm``."""
    calls = []
    real = ops.mpmm

    def spy(x, w_data, w_scale, *, w_bits, **kw):
        calls.append((tuple(x.shape), tuple(w_data.shape), w_bits))
        return real(x, w_data, w_scale, w_bits=w_bits, **kw)

    monkeypatch.setattr(ops, "mpmm", spy)
    x = torch.randn(3, 8, 128, generator=torch.Generator().manual_seed(0))
    cap = int((24 * 2 * 1.25) // 8)
    for bits in (4, 8):
        calls.clear()
        tmoe.moe_ffn(x, _carry(_moe_params("float32", bits)), top_k=2)
        k_in = 128 // 2 if bits == 4 else 128
        k_down = 256 // 2 if bits == 4 else 256
        assert calls == [c for _ in range(8) for c in (
            ((cap, 128), (k_in, 256), bits), ((cap, 128), (k_in, 256), bits),
            ((cap, 256), (k_down, 128), bits))]
    calls.clear()
    tmoe.moe_ffn(x, _carry(_moe_params("float32", 16)), top_k=2)
    assert calls == []


def _shapes(tree):
    """{name: (shape, dtype name)} of a parameter tree, quantized leaves'
    ``bits`` left out."""
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items() if k != "bits"}


@pytest.mark.parametrize("name,bits", [("mixtral", 4), ("kimi", 8)])
def test_moe_params_and_quantization_match_jax(request, name, bits):
    """init_params' tree (``dense_blocks`` for kimi's first_dense) has the
    JAX shapes and dtypes; quantize_params packs the stacked experts
    [L, E, K, N] bit-equal to the JAX vmap, the router stays f32."""
    _, tcfg, jp, carried = request.getfixturevalue(name)
    ours = tT.init_params(tcfg, torch.Generator().manual_seed(1))
    assert _shapes(ours) == _shapes(jax.tree.map(np.asarray, jp))
    jq = jax.tree.map(np.asarray, jT.quantize_params(jp, bits))
    tq = tT.quantize_params(carried, bits)
    for key in ("wg", "wu", "wd"):
        for part in ("data", "scale"):
            assert np.array_equal(tq["blocks"]["moe"][key][part].numpy(),
                                  jq["blocks"]["moe"][key][part])
    assert tq["blocks"]["moe"]["router"].dtype == torch.float32
    assert _shapes(tT.quantize_params(ours, bits)) == _shapes(jq)
    assert ("dense_blocks" in ours) == (name == "kimi")


# ------------------------------------------------------- paged engine
def _serve(engine_cls, cfg, params, prompts, precisions, new_tokens, **kw):
    port = engine_cls is ServeEngine
    samp, prec = (SamplingParams, PrecisionParams) if port else (JSampling, JPrecision)
    eng = engine_cls(cfg, params, **kw, **({"device": "cpu"} if port else {}))
    reqs = [eng.submit(p, samp(max_new_tokens=new_tokens), prec(**pr))
            for p, pr in zip(prompts, precisions)]
    eng.run()
    return [r.out_tokens for r in reqs], eng.stats


def test_mixtral_engine_streams_match_jax(mixtral):
    """Reduced mixtral (4 MoE layers, 8 experts top-2, window 64) through
    both engines: four requests over (w, kv) in (4,8) (8,4) (16,16) (8,8),
    a shared 18-token prefix, prompts past the window, chunks of 16 tokens:
    every MoE call runs on a pow2-padded batch whose padding rows take
    capacity, as in JAX.  Greedy streams and counters equal."""
    cfg, tcfg, jparams, tparams = mixtral
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, 18)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n)]).astype(np.int32)
               for n in (60, 5, 23, 9)]
    precisions = [dict(w_bits=w, kv_bits=k) for w, k in ((4, 8), (8, 4), (16, 16), (8, 8))]
    kw = dict(max_slots=3, page_size=8, prefill_chunk=16, num_pages=48)
    j_out, j_stats = _serve(JEngine, cfg, jparams, prompts, precisions, 6, **kw)
    t_out, t_stats = _serve(ServeEngine, tcfg, tparams, prompts, precisions, 6, **kw)
    assert t_out == j_out and all(len(o) == 6 for o in t_out)
    for name in ("prefill_chunks", "decode_steps", "mixed_precision_steps",
                 "prefix_hit_tokens"):
        assert getattr(t_stats, name) == getattr(j_stats, name), name
    assert t_stats.mixed_precision_steps > 0


def test_mixtral_spec_stream_matches_jax(mixtral):
    """Greedy speculation (spec_k 3, w4 draft of the w8 target, kv8): the
    verify window's MoE runs on B x 4 tokens; streams and spec counters
    equal JAX's."""
    cfg, tcfg, jparams, tparams = mixtral
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (11, 17)]
    precisions = [dict(w_bits=8, kv_bits=8, draft_bits=4)] * 2
    kw = dict(max_slots=2, page_size=4, prefill_chunk=8, num_pages=32, spec_k=3)
    j_out, j_stats = _serve(JEngine, cfg, jparams, prompts, precisions, 8, **kw)
    t_out, t_stats = _serve(ServeEngine, tcfg, tparams, prompts, precisions, 8, **kw)
    assert t_out == j_out
    assert t_stats.spec_rounds == j_stats.spec_rounds > 0
    assert t_stats.spec_accepted_tokens == j_stats.spec_accepted_tokens


def test_engine_refuses_leading_dense_moe_blocks():
    """The JAX rule: MoE with first_dense is no uniform stack for the paged
    engine (kimi-k2 goes to the waves); mixtral is served."""
    _, kimi = _cfgs("kimi-k2-1t-a32b")
    _, mix = _cfgs("mixtral-8x22b")
    assert not ServeEngine.supports(kimi) and ServeEngine.supports(mix)
    assert not engine_family(kimi) and engine_family(mix)
    with pytest.raises(NotImplementedError, match="leading dense"):
        ServeEngine(kimi, {}, device="cpu")


# -------------------------------------------------------- static waves
def test_kimi_waves_match_jax(kimi):
    """Reduced kimi-k2 (one dense block, then 3 MoE blocks of 8 experts
    top-2; w4 weights, kv8) through both Servers: 3 requests in 2 waves,
    ragged prompts and budgets; greedy streams and counts equal."""
    cfg, tcfg, params, carried = kimi
    rng = np.random.default_rng(6)
    prompts = [(rng.integers(0, 512, n).astype(np.int32), m) for n, m in ((9, 5), (4, 3), (7, 4))]

    def run(server_cls, request_cls, c, p, **kw):
        srv = server_cls(c, p, batch_size=2, max_len=24, **kw)
        reqs = [request_cls(rid=i, prompt=pr, max_new_tokens=m)
                for i, (pr, m) in enumerate(prompts)]
        srv.serve(reqs)
        return [list(r.out_tokens) for r in reqs], srv

    theirs, jsrv = run(JServer, JRequest, cfg, params)
    mine, tsrv = run(Server, Request, tcfg, carried, device="cpu")
    assert tsrv.engine is None and tsrv.w_bits == 4
    assert mine == theirs and [len(s) for s in mine] == [5, 3, 4]
    assert (tsrv.stats.tokens_out, tsrv.stats.decode_steps) == (
        jsrv.stats.tokens_out, jsrv.stats.decode_steps)


def test_kimi_prefill_and_decode_step_match_jax(kimi):
    """The contiguous-cache prefill and two decode steps of reduced kimi-k2
    (f32, unquantized, kv16): logits within 1e-4 of the largest magnitude,
    the cache's K/V too."""
    cfg, tcfg, params, ours = kimi
    cfg, tcfg = (dataclasses.replace(c, serve_kv_bits=16) for c in (cfg, tcfg))
    tokens = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)

    def close(got, exp):
        got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
        assert np.abs(got - exp).max() <= 1e-4 * np.abs(exp).max()

    jlog, jcache = jT.prefill(params, {"tokens": jnp.asarray(tokens)}, cfg, 16)
    tlog, tcache = tT.prefill(ours, {"tokens": torch.from_numpy(tokens)}, tcfg, 16)
    close(tlog.numpy()[:, :cfg.vocab], np.asarray(jlog)[:, :cfg.vocab])
    for step in range(2):
        tok = tlog.argmax(-1, keepdim=True).int()
        jlog, jcache = jT.decode_step(params, jnp.asarray(tok.numpy()), jcache, cfg)
        tlog, tcache = tT.decode_step(ours, tok, tcache, tcfg)
        close(tlog.numpy()[:, :cfg.vocab], np.asarray(jlog)[:, :cfg.vocab])
    for key in ("k", "v"):
        close(tcache[key].numpy(), np.asarray(jcache[key]))
    assert int(tcache["pos"]) == int(jcache["pos"]) == 11


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_launcher_serves_moe_archs(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--batch-size", "2",
            "--prompt-len", "10", "--new-tokens", "3", "--page-size", "4"]
    report = tserve.main(argv + ["--device", "cpu"])
    jreport = jserve.main(argv)
    capsys.readouterr()
    assert set(report) - set(jreport) == {"device"} and set(jreport) <= set(report)
    assert report["tokens_out"] == jreport["tokens_out"] == 9
    assert ("scheduler" in report) == (arch == "kimi-k2-1t-a32b")
