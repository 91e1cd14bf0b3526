"""Multi-precision continuous-batching serving (port of
``examples/serve_quantized.py``): W4A16, W8A16 and bf16 requests share ONE
engine and decode in the same engine steps (one batched kernel call per
precision group), and requests with the same system prompt share
prefix-cache KV pages instead of re-prefilling them (cross-precision
isolated: a bf16 request never reads int8 prefix pages, and W4-computed K/V
never serves a W8 request).  On the card the W4 / W8 projections run the
CF dequant kernel and attention the paged decode and prefill kernels, each
step captured as a CUDA graph; on the CPU their plain versions.  The
weights are drawn from seed 0 with the port's generator (not JAX's numbers),
so the tokens differ from the JAX example's; its assertions hold here too.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import tree
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.outputs import GenerationOutput, StreamEvent
from repro_torch.serve.params import PrecisionParams, SamplingParams

# wave 1 seeds the prefix cache: one request per (w_bits, kv_bits) group;
# wave 2 is the same mixed-precision stream over a warm prefix cache
SEED_SPEC = [(4, 8), (8, 8), (16, 16)]
SPEC = [(4, 8), (8, 8), (4, 8), (8, 8), (16, 16), (4, 8)]


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = dataclasses.replace(
        get_config("yi-9b").reduced(), n_layers=4, d_model=256, d_ff=512,
        n_heads=4, n_kv_heads=2, head_dim=64, vocab=4096,
    )
    params = T.init_params(base, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    engine = ServeEngine(base, params, max_slots=6, num_pages=96, page_size=8, device=dev)

    # every request shares one 16-token system prompt + a unique 8-token tail
    system_prompt = rng.integers(0, base.vocab, 16).astype(np.int32)

    def prompt():
        return np.concatenate([system_prompt, rng.integers(0, base.vocab, 8).astype(np.int32)])

    for w, kv in SEED_SPEC:
        engine.submit(prompt(), SamplingParams(max_new_tokens=12),
                      PrecisionParams(w_bits=w, kv_bits=kv))
        engine.run()
    assert engine.stats.prefix_hit_tokens == 0, \
        "disjoint precision groups must not share prefix pages"

    reqs = [engine.submit(prompt(), SamplingParams(max_new_tokens=12),
                          PrecisionParams(w_bits=w, kv_bits=kv)) for w, kv in SPEC]
    engine.run()

    def payload_bytes(params):
        return sum(t.numel() * t.element_size() for t in tree.leaves(params)
                   if isinstance(t, torch.Tensor))

    print(f"{'request':<10}{'weights':>10}{'kv':>6}   first tokens")
    for r in reqs:
        assert r.done and len(r.out_tokens) == 12
        kv = "int8" if r.kv_bits == 8 else "bf16"
        print(f"req {r.rid:<6}w{r.w_bits:<9}{kv:<6}   {r.out_tokens[:6]}")
    payload = {w: payload_bytes(engine.params_for(w)) for w in sorted({w for w, _ in SPEC})}
    print("\nweight payload per precision (same model, one engine):")
    for w, n in payload.items():
        print(f"  w{w:<3} {n / 1e6:8.1f} MB")

    s = engine.stats
    print(f"\nengine: {s.tokens_out} tokens, {s.decode_tok_per_s:.1f} decode tok/s, "
          f"mean batch occupancy {s.mean_batch_occupancy:.1f}")
    print("decode kernel groups: "
          + ", ".join(f"w{w}/kv{k}x{n}" for (w, k), n in sorted(s.group_calls.items())))
    print(f"engine steps decoding >=2 precision groups at once: {s.mixed_precision_steps}")
    assert s.mixed_precision_steps > 0, "expected W4 and W8 requests in one decode batch"

    # every wave-2 request hit its own precision group's cached system
    # prompt, and only its own group's: the int8 pool serves w4 and w8
    # requests from separate page chains (hash-chain salt), bf16 from a
    # separate pool
    print(f"\nprefix cache: hit rate {s.prefix_hit_rate:.0%} of admitted prompt "
          f"tokens ({s.prefix_hit_tokens} cached / {s.prefix_new_tokens} computed)")
    for kv_bits in (8, 16):
        pc = engine.prefix_cache_for(kv_bits)
        print(f"  kv{kv_bits} pool: {pc.num_entries} cached blocks, "
              f"{pc.stats.evictions} evicted, {pc.stats.forks} CoW forks")
    assert s.prefix_hit_tokens == 16 * len(SPEC), "warm wave should hit the full system prompt"

    print("\n(W4+W8+bf16 requests were continuously batched in one engine; "
          "w4 halves the w8 matmul-weight payload, greedy continuations stay "
          "consistent, and the shared system prompt prefilled once per precision "
          "group, never across groups)")

    # streaming sampled generation, the generate() API: per-request seeded
    # sampling (temperature / top-p) with per-token streaming; the same seed
    # reproduces the same stream, different seeds diverge
    def stream(seed):
        events, outs = [], []
        sampling = SamplingParams(temperature=0.8, top_p=0.95, seed=seed, max_new_tokens=8)
        for ev in engine.generate([(prompt(), sampling, PrecisionParams(w_bits=4, kv_bits=8))]):
            if isinstance(ev, StreamEvent):
                events.append(ev.token)
            else:
                outs.append(ev)
        return events, outs

    rng = np.random.default_rng(42)  # reset so both calls build the same prompt
    toks_a, (out_a,) = stream(seed=7)
    rng = np.random.default_rng(42)
    toks_b, (out_b,) = stream(seed=7)
    rng = np.random.default_rng(42)
    toks_c, (out_c,) = stream(seed=8)

    print("\nstreaming sampled generation (temperature 0.8, top-p 0.95):")
    print(f"  seed 7:        {toks_a}  (finish: {out_a.finish_reason})")
    print(f"  seed 7 again:  {toks_b}")
    print(f"  seed 8:        {toks_c}")
    assert isinstance(out_a, GenerationOutput) and list(out_a.tokens) == toks_a
    assert toks_a == toks_b, "a fixed seed must reproduce the stream exactly"
    assert toks_a != toks_c, "a different seed should diverge (w.h.p.)"
    return {"device": str(dev), "streams": [list(r.out_tokens) for r in reqs],
            "payload_bytes": payload, "tokens_out": s.tokens_out,
            "mixed_precision_steps": s.mixed_precision_steps,
            "prefix_hit_tokens": s.prefix_hit_tokens, "group_calls": dict(s.group_calls),
            "sampled": {"seed7": toks_a, "seed8": toks_c},
            "graphs": {"captured": engine.graphs.captured, "replays": engine.graphs.replays}}


if __name__ == "__main__":
    main()
