"""The PyTorch port's ServeEngine against the JAX package's on a reduced
float32 llama3.2-3b (weights carried over with params_from_numpy): greedy
streams are token-identical across a mixed (w_bits, kv_bits) batch over
{4, 8, 16} with warm prefix-cache hits, and under forced preemption.  Also
the port's serving CLI end to end on the CPU, the JAX engine's deprecated
flat-kwargs submit (not ported) raising, and a vlm engine (prefix
embeddings, one-shot prefill) serving with no prefix cache."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype="float32")
    params = jT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _serve(engine_cls, sampling_cls, precision_cls, cfg, params, prompts, precisions,
           new_tokens, **kw):
    extra = {"device": "cpu"} if engine_cls is ServeEngine else {}
    eng = engine_cls(cfg, params, **kw, **extra)
    reqs = [
        eng.submit(p, sampling_cls(max_new_tokens=new_tokens), precision_cls(w_bits=w, kv_bits=k))
        for p, (w, k) in zip(prompts, precisions)
    ]
    eng.run()
    return [r.out_tokens for r in reqs], eng.stats


def _both(models, prompts, precisions, new_tokens, **kw):
    cfg, tcfg, jparams, tparams = models
    theirs = _serve(JEngine, JSampling, JPrecision, cfg, jparams, prompts, precisions,
                    new_tokens, **kw)
    ours = _serve(ServeEngine, SamplingParams, PrecisionParams, tcfg, tparams, prompts,
                  precisions, new_tokens, **kw)
    return theirs, ours


def test_mixed_precision_prefix_hits_match_jax(models):
    """Six requests sharing a 19-token system prompt, three slots, weight/KV
    precision cycling over (4,8) (8,4) (16,16): requests 3..5 are admitted
    after their same-precision predecessors finished and adopt the cached
    prefix pages."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 19)
    prompts = [np.concatenate([shared, rng.integers(0, 512, 4 + i)]).astype(np.int32)
               for i in range(6)]
    precisions = [(4, 8), (8, 4), (16, 16)] * 2
    (j_out, j_stats), (t_out, t_stats) = _both(
        models, prompts, precisions, 6, max_slots=3, page_size=8, prefill_chunk=16,
        num_pages=32,
    )
    assert t_out == j_out
    assert all(len(o) == 6 for o in t_out)
    assert t_stats.prefix_hit_tokens == j_stats.prefix_hit_tokens > 0
    assert t_stats.mixed_precision_steps == j_stats.mixed_precision_steps > 0
    assert t_stats.prefill_chunks == j_stats.prefill_chunks


def test_forced_preemption_matches_jax(models):
    """Three same-precision requests on a pool of 9 pages: all three prompts
    fit (3 pages each), growth does not, so the youngest is preempted and
    recomputed; streams still equal the JAX engine's."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, 20).astype(np.int32) for _ in range(3)]
    (j_out, j_stats), (t_out, t_stats) = _both(
        models, prompts, [(8, 8)] * 3, 10, max_slots=3, page_size=8, prefill_chunk=32,
        num_pages=9,
    )
    assert t_out == j_out
    assert t_stats.preemptions == j_stats.preemptions > 0


def test_generate_streams_and_stop_tokens(models):
    """generate() yields every token once, in order, then the terminal
    output; a stop token ends the stream with finish_reason "stop"."""
    _, tcfg, _, tparams = models
    eng = ServeEngine(tcfg, tparams, max_slots=2, page_size=8, device="cpu")
    prompt = np.arange(9, dtype=np.int32)
    first = eng.submit(prompt, SamplingParams(max_new_tokens=5), PrecisionParams(w_bits=8))
    eng.run()
    stop = first.out_tokens[2]
    eng2 = ServeEngine(tcfg, tparams, max_slots=2, page_size=8, device="cpu")
    events = list(eng2.generate([
        (prompt, SamplingParams(max_new_tokens=5, stop_tokens=(stop,)), PrecisionParams(w_bits=8)),
    ]))
    tokens = [e.token for e in events[:-1]]
    assert tokens == first.out_tokens[: first.out_tokens.index(stop) + 1]
    assert events[-2].finish_reason == "stop" and events[-1].finish_reason == "stop"
    assert eng2.cache_for(8).k.device == torch.device("cpu")  # the pool stays put


def test_oversized_request_fails(models):
    _, tcfg, _, tparams = models
    eng = ServeEngine(tcfg, tparams, num_pages=2, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="never fit"):
        eng.submit(np.arange(10, dtype=np.int32), SamplingParams(max_new_tokens=4))


def test_unported_options_raise(models):
    """The JAX engine's deprecated flat-kwargs ``submit(prompt, 16,
    w_bits=4)`` is not ported and raises.  Frontend prefix embeddings
    (prefix_len > 0) are: a vlm engine over the same dense weights serves on
    the CPU through the one-shot prefill, with no prefix cache even when one
    is asked for (their parity with JAX: tests/test_torch_frontends.py)."""
    _, tcfg, _, tparams = models
    eng = ServeEngine(tcfg, tparams, device="cpu")
    with pytest.raises(TypeError):
        eng.submit(np.arange(5, dtype=np.int32), 16, w_bits=4)
    vlm = dataclasses.replace(tcfg, family="vlm", prefix_len=4)
    eng = ServeEngine(vlm, tparams, max_slots=2, page_size=4, enable_prefix_cache=True,
                      device="cpu")
    reqs = [eng.submit(np.arange(1, 7, dtype=np.int32), SamplingParams(max_new_tokens=3))
            for _ in range(2)]
    eng.run()
    assert all(len(r.out_tokens) == 3 for r in reqs)
    assert eng._prefix == {} and eng.stats.prefix_hit_tokens == 0
    assert eng.stats.prefills == 2 and eng.stats.prefill_chunks == 0


def test_launch_serve_cli_end_to_end():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3.2-3b",
         "--reduced", "--device", "cpu", "--requests", "3", "--prompt-len", "12",
         "--new-tokens", "4", "--batch-size", "2", "--page-size", "4",
         "--precision-mix", "4,8", "--shared-prefix", "8"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["device"] == "cpu"
    assert report["tokens_out"] == report["stream_events"] == 12
    assert report["mixed_precision_steps"] > 0
    assert report["prefix_hit_tokens"] > 0  # the third request follows the first two
    assert report["finish_reasons"] == ["length"] * 3
