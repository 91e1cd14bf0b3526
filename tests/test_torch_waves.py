"""The port's static-wave serving path against the JAX package: the
contiguous-cache ``prefill`` and ``decode_step`` of the ssm and hybrid
families, the ``Server`` facade's waves, and the launcher's static-wave
branch.

Configs: reduced zamba2-7b (hybrid: 4 groups of 2 SSM layers and the shared
attention block), the same cut to 5 layers (2 groups and a 1-layer SSM
tail), and reduced mamba2-130m (ssm), all in float32 with the JAX weights
carried over by ``params_from_numpy``.  Tolerances: logits, SSM states, KV
scales and unquantized K/V within 1e-4 of the largest magnitude (the
frameworks sum the projections in other orders, so K and V differ in their
last f32 bits); int8 KV payloads equal except where such a last-bit
difference moved a value across a rounding boundary: there one LSB apart, in
at most 1 of 1000 entries.  Greedy streams token-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train.server import Request as JRequest  # noqa: E402
from repro.train.server import Server as JServer  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.train.server import Request, Server, engine_family  # noqa: E402

RTOL = 1e-4
_jprefill = jax.jit(jT.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(jT.decode_step, static_argnames=("cfg",))
# (arch, n_layers override): hybrid without and with a tail, and ssm
ARCHS = [("zamba2-7b", None), ("zamba2-7b", 5), ("mamba2-130m", None)]


def _cfgs(name, n_layers, **kw):
    over = dict(dtype="float32", **kw)
    if n_layers:
        over["n_layers"] = n_layers
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    tcfg = dataclasses.replace(tget(name).reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    return cfg, tcfg


def _close_rel(got, exp, rtol=RTOL):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape
    err = np.abs(got - exp).max()
    assert err <= rtol * max(np.abs(exp).max(), 1e-30), err


def _check_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    assert tcache["pos"] == int(jcache["pos"])
    for name, jv in jcache.items():
        if name == "pos":
            continue
        got, exp = tcache[name].numpy(), np.asarray(jv)
        if got.dtype == np.int8:
            off = got.astype(np.int32) != exp
            assert np.abs(got.astype(np.int32) - exp).max() <= 1, name
            assert off.mean() <= 1e-3, (name, int(off.sum()), off.size)
        else:  # SSM states, KV scales, unquantized K/V
            _close_rel(got, exp)


@pytest.mark.parametrize("w_bits,kv_bits", [(8, 8), (16, 16)])
@pytest.mark.parametrize("name,n_layers", ARCHS)
def test_prefill_and_decode_step_match_jax(name, n_layers, w_bits, kv_bits):
    cfg, tcfg = _cfgs(name, n_layers, serve_kv_bits=kv_bits)
    params = jT.init_params(cfg, jax.random.PRNGKey(n_layers or 0))
    if w_bits < 16:
        params = jT.quantize_params(params, w_bits)
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    max_len = 16

    jlog, jcache = _jprefill(params, {"tokens": jnp.asarray(tokens)}, cfg=cfg, max_len=max_len)
    tlog, tcache = tT.prefill(ours, {"tokens": torch.from_numpy(tokens)}, tcfg, max_len)
    _close_rel(tlog.numpy()[:, : cfg.vocab], np.asarray(jlog)[:, : cfg.vocab])
    assert (tlog.numpy()[:, cfg.vocab:] == -1e30).all()
    _check_cache(tcache, jcache)
    # each decode step starts from the JAX cache carried over, so a payload
    # one LSB apart from the prefill does not move the next step's logits
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        carried = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
        jlog, jcache = _jdecode(params, jnp.asarray(tok), jcache, cfg=cfg)
        tlog, tcache = tT.decode_step(ours, torch.from_numpy(tok), carried, tcfg)
        assert tcache is carried and tcache["pos"] == 12 + _  # updated in place
        _close_rel(tlog.numpy()[:, : cfg.vocab], np.asarray(jlog)[:, : cfg.vocab])
        _check_cache(tcache, jcache)


def test_decode_step_refuses_kv4_and_unported_families():
    cfg, tcfg = _cfgs("zamba2-7b", 5, serve_kv_bits=4)
    ours = tT.init_params(tcfg, torch.Generator().manual_seed(0))
    cache = tT.init_cache(tcfg, 1, 8)
    assert cache["k"].shape[-1] == tcfg.hd // 2  # nibble-packed, as in JAX
    with pytest.raises(NotImplementedError, match="int4 KV"):
        tT.decode_step(ours, torch.zeros(1, 1, dtype=torch.int64), cache, tcfg)
    # the vlm and audio families, once refused, take the dense stack's
    # attention cache, as in JAX
    for fam in ("vlm", "audio"):
        jcfg = dataclasses.replace(cfg, family=fam, serve_kv_bits=8)
        tcache = tT.init_cache(dataclasses.replace(tcfg, family=fam, serve_kv_bits=8), 1, 8)
        jshapes = {k: tuple(v.shape) for k, v in jT.init_cache(jcfg, 1, 8).items()}
        assert {k: tuple(v.shape) for k, v in tcache.items()} == jshapes
        assert "ssm" not in tcache and tcache["k"].shape[0] == tcfg.n_layers


def test_param_count_and_init_shapes_match_jax():
    for name in ("zamba2-7b", "mamba2-130m"):
        assert tget(name).param_count() == get_config(name).param_count()
    assert round(tget("zamba2-7b").param_count() / 1e9, 3) == 6.747
    for name, n_layers in ARCHS:
        cfg, tcfg = _cfgs(name, n_layers)
        jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                               jT.init_params(cfg, jax.random.PRNGKey(0)))
        ours = tT.init_params(tcfg, torch.Generator().manual_seed(0))
        tshapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), ours)
        assert tshapes == jshapes


# ------------------------------------------------------------------ Server
def _streams(server_cls, request_cls, cfg, params, prompts, quantize, **kw):
    srv = server_cls(cfg, params, batch_size=2, max_len=24, quantize=quantize, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(prompts)]
    srv.serve(reqs)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], srv.stats


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("name,n_layers", ARCHS)
def test_server_waves_match_jax(name, n_layers, quantize):
    """3 requests in 2 waves (batch_size 2), ragged prompts left-padded,
    ragged max_new_tokens: token-identical greedy streams and the same
    counts."""
    cfg, tcfg = _cfgs(name, n_layers)
    params = jT.init_params(cfg, jax.random.PRNGKey(5))
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(2)
    prompts = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
               for n, m in ((7, 5), (4, 3), (6, 4))]
    theirs, jstats = _streams(JServer, JRequest, cfg, params, prompts, quantize)
    mine, tstats = _streams(Server, Request, tcfg, ours, prompts, quantize, device="cpu")
    assert mine == theirs
    assert [len(s) for s in mine] == [5, 3, 4]
    assert (tstats.tokens_out, tstats.decode_steps) == (jstats.tokens_out, jstats.decode_steps)


def test_server_routes_families_by_the_jax_rule():
    """Dense goes to the port's engine, and so do vlm/audio, which JAX's paged
    engine hosts (moe: tests/test_torch_moe.py)."""
    dense = tget("llama3.2-3b").reduced()
    assert engine_family(dense) and not engine_family(tget("zamba2-7b"))
    srv = Server(dense, tT.init_params(dense, torch.Generator().manual_seed(0)),
                 batch_size=2, max_len=32, device="cpu")
    reqs = [Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=3)]
    srv.serve(reqs)
    assert srv.engine is not None and len(reqs[0].out_tokens) == 3
    for fam in ("vlm", "audio"):
        cfg = dataclasses.replace(dense, family=fam, prefix_len=4)
        fsrv = Server(cfg, tT.init_params(cfg, torch.Generator().manual_seed(0)),
                      batch_size=2, max_len=32, device="cpu")
        freqs = [Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=3)]
        fsrv.serve(freqs)
        assert engine_family(cfg) and fsrv.engine is not None
        assert len(freqs[0].out_tokens) == 3
    with pytest.raises(NotImplementedError, match="greedy"):
        srv.serve(reqs, greedy=False)


# ---------------------------------------------------------------- launcher
def test_launcher_static_wave_report(capsys):
    from repro.launch.serve import main as jmain

    argv = ["--arch", "mamba2-130m", "--reduced", "--requests", "3", "--batch-size", "2",
            "--prompt-len", "6", "--new-tokens", "3"]
    report = tserve.main(argv + ["--device", "cpu"])
    jreport = jmain(argv)
    capsys.readouterr()
    assert set(report) - set(jreport) == {"device"} and set(jreport) <= set(report)
    assert report["scheduler"] == jreport["scheduler"]
    assert (report["requests"], report["tokens_out"], report["w_bits"]) == (3, 9, 8)
    assert report["device"] == "cpu"
    report = tserve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                          "--requests", "2", "--new-tokens", "2", "--no-quantize"])
    capsys.readouterr()
    assert report["w_bits"] == 16 and report["tokens_out"] == 4


@pytest.mark.parametrize("flag", [["--temperature", "0.8"], ["--top-k", "5"],
                                  ["--top-p", "0.9"]])
def test_launcher_refuses_sampling_flags_on_static_waves(flag):
    with pytest.raises(SystemExit, match="static-wave"):
        tserve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu", *flag])
