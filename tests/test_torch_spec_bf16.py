"""Greedy speculative decoding in bfloat16: spec-on against spec-off, in
the JAX package's engine and in the port's, on the CPU.

The reference promises that a greedy stream is the same with speculation on
or off.  On the card ~7% of the port's greedy spec tokens left the spec-off
stream in bf16 (its verify runs the paged prefill kernel, its plain decode
the paged decode kernel: two summation orders), while in float32 on the CPU
spec-on = spec-off = JAX (``tests/test_torch_spec.py``).  This file holds
the bf16 case on the CPU: reduced llama3.2-3b in its own bfloat16, the JAX
weights carried over bit for bit, three requests at (w, kv, draft) (8, 8,
4), (16, 16, 8) and (4, 4, 4), 16 greedy tokens each, ``spec_k`` 3.  Both
engines keep spec-on equal to spec-off, token for token, with rounds run
and drafts rejected; so the port's verify path agrees with its decode path
where JAX's does.  The port's bf16 streams are not held to JAX's: the two
frameworks round bf16 at other places (ROADMAP, "Known, and not faults").
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

PRECISIONS = [dict(w_bits=8, kv_bits=8, draft_bits=4), dict(w_bits=16, kv_bits=16, draft_bits=8),
              dict(w_bits=4, kv_bits=4, draft_bits=4)]
NEW, SPEC_K = 16, 3
ENGINE = dict(max_slots=3, num_pages=64, page_size=4, prefill_chunk=16)


@pytest.fixture(scope="module")
def runs():
    """{(engine, spec_k): (streams, stats)} for both engines, spec off and on."""
    cfg, tcfg = get_config("llama3.2-3b").reduced(), tget("llama3.2-3b").reduced()
    assert cfg.dtype == tcfg.dtype == "bfloat16"
    params = jT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 9).astype(np.int32) for _ in PRECISIONS]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many small ops: fan-out only slows them
    out = {}
    try:
        for name, spec_k in (("jax", 0), ("jax", SPEC_K), ("port", 0), ("port", SPEC_K)):
            if name == "port":
                eng = ServeEngine(tcfg, tparams, spec_k=spec_k, device="cpu", **ENGINE)
                samp, prec = SamplingParams, PrecisionParams
            else:
                eng = JEngine(cfg, params, spec_k=spec_k, **ENGINE)
                samp, prec = JSampling, JPrecision
            reqs = [eng.submit(p, samp(max_new_tokens=NEW), prec(**pr))
                    for p, pr in zip(prompts, PRECISIONS)]
            eng.run()
            out[name, spec_k] = ([[int(t) for t in r.out_tokens] for r in reqs], eng.stats)
    finally:
        torch.set_num_threads(n_threads)
    return out


@pytest.mark.parametrize("name", ["jax", "port"])
def test_bf16_greedy_spec_on_equals_spec_off(runs, name):
    off, _ = runs[name, 0]
    on, stats = runs[name, SPEC_K]
    assert [len(s) for s in on] == [NEW] * len(PRECISIONS)
    assert on == off
    # the rounds ran and rejected drafts: the equality is not vacuous
    assert stats.spec_rounds > 0 and 0 < stats.spec_accepted_tokens < stats.spec_draft_tokens
