"""The port's config registry against the JAX package's, and the two dense
configs added with it served by the port's engine against the JAX engine.

Every arch the port registers has the JAX config field for field, the same
``param_count`` and ``active_param_count`` (full and reduced), and
``configs.shapes`` gives the same shape set and cells.  Reduced minitron-4b
and gemma3-1b cut to 6 layers (five local layers with the reduced window of
64, then a global one) run through both engines in float32 on the JAX
weights: prompts longer than the window make it bind on the local layers,
and the greedy streams are token-identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cells_for_arch as jcells  # noqa: E402
from repro.configs import get_config, list_archs as jlist  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import SHAPES, cells_for_arch, list_archs  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

NEW_ARCHS = ("gemma3-1b", "minitron-4b", "mixtral-8x22b", "kimi-k2-1t-a32b")


def test_registry_holds_the_new_archs():
    """The port lists every arch the JAX package does (the vlm and audio
    archs last)."""
    assert set(NEW_ARCHS) <= set(list_archs())
    assert list_archs() == jlist()
    assert {tget(n).family for n in ("paligemma-3b", "musicgen-medium")} == {"vlm", "audio"}


@pytest.mark.parametrize("name", sorted(set(list_archs())))
def test_config_and_param_counts_match_jax(name):
    for cfg, tcfg in ((get_config(name), tget(name)),
                      (get_config(name).reduced(), tget(name).reduced())):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        assert tcfg.param_count() == cfg.param_count()
        assert tcfg.active_param_count() == cfg.active_param_count()
    assert cells_for_arch(tget(name)) == jcells(get_config(name))


def test_moe_published_sizes():
    """The MoE counts their sources publish, to the precision the formula
    keeps (no norms, no shared expert): mixtral 8x22b ~141B with ~39B
    active, kimi-k2 ~1T with ~31B active (32B published, with its shared
    expert)."""
    giga = {name: (tget(name).param_count() / 1e9, tget(name).active_param_count() / 1e9)
            for name in ("mixtral-8x22b", "kimi-k2-1t-a32b")}
    assert 139 < giga["mixtral-8x22b"][0] < 142 and 38 < giga["mixtral-8x22b"][1] < 40
    assert 1000 < giga["kimi-k2-1t-a32b"][0] < 1050 and 30 < giga["kimi-k2-1t-a32b"][1] < 33


def test_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


# ------------------------------------------------------------ engine
def _serve(engine_cls, cfg, params, prompts, precisions, new_tokens, **kw):
    port = engine_cls is ServeEngine
    samp, prec = (SamplingParams, PrecisionParams) if port else (JSampling, JPrecision)
    eng = engine_cls(cfg, params, **kw, **({"device": "cpu"} if port else {}))
    reqs = [eng.submit(p, samp(max_new_tokens=new_tokens), prec(w_bits=w, kv_bits=k))
            for p, (w, k) in zip(prompts, precisions)]
    eng.run()
    return [r.out_tokens for r in reqs], eng.stats


@pytest.mark.parametrize("name,n_layers,lengths", [
    ("minitron-4b", None, (21, 9, 30)),
    ("gemma3-1b", 6, (97, 70, 130)),
])
def test_dense_engine_streams_match_jax(name, n_layers, lengths):
    over = dict(dtype="float32", **({"n_layers": n_layers} if n_layers else {}))
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    tcfg = dataclasses.replace(tget(name).reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    if name == "gemma3-1b":
        windows = tT._per_layer_window(tcfg, tcfg.n_layers)
        assert windows[:5] == [64] * 5 and windows[5] > 1 << 20
        assert max(lengths) > cfg.window  # the window binds on the local layers
    params = jT.init_params(cfg, jax.random.PRNGKey(2))
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]
    precisions = [(4, 8), (8, 4), (16, 16)]
    kw = dict(max_slots=3, page_size=8, prefill_chunk=32, num_pages=64)
    j_out, j_stats = _serve(JEngine, cfg, params, prompts, precisions, 5, **kw)
    t_out, t_stats = _serve(ServeEngine, tcfg, ours, prompts, precisions, 5, **kw)
    assert t_out == j_out and all(len(o) == 5 for o in t_out)
    assert (t_stats.prefill_chunks, t_stats.decode_steps) == (
        j_stats.prefill_chunks, j_stats.decode_steps)
