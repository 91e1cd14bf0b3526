"""Serving launcher of the port: continuous-batching multi-precision
quantized inference on the card (the paper's use case at traffic).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --new-tokens 16 --precision-mix 4,8 --shared-prefix 64

Same flags as ``repro.launch.serve`` plus ``--device`` (default ``cuda``;
with no card present that raises instead of running on the CPU, so pass
``--device cpu`` to run the kernels' plain versions).  ``--precision-mix``
assigns weight precisions to requests round-robin, so one engine decodes
W4A16 and W8A16 requests in the same step.  ``--shared-prefix N`` gives every
request the same N-token system prompt (followers hit the prefix cache).
Weights and prompts are random, drawn from ``--seed``.

Sampling: ``--temperature`` (0 = greedy argmax, the default), ``--top-k``
and ``--top-p`` build each request's ``SamplingParams``; request ``i`` uses
the sampling seed ``--seed + i``, so a rerun with the same seed replays
every stream.  ``--spec-k K`` turns on self-speculative decoding: every
request drafts up to K tokens a round with the ``--draft-bits`` weight set
and verifies them in one pass at its own precision (exact acceptance when
greedy, rejection sampling when sampled; the ``spec_*`` keys of the
report).  Run on the CPU with ``--device cpu``, for example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --reduced --device cpu --temperature 0.8 --top-p 0.95 --spec-k 3

Every registered arch resolves through ``get_config``: the dense configs
(llama3.2-3b, yi-9b, minitron-4b, gemma3-1b with its 5:1 local:global
window), mixtral-8x22b (moe) and the archs with a frontend prefix
(paligemma-3b, vlm; musicgen-medium, audio: their prompts follow the stub
frontend's ``prefix_len`` embeddings, prefilled in one shot with no prefix
cache) run on the paged engine, for example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --reduced --device cpu --precision-mix 4,8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --reduced --device cpu

Archs the JAX package's paged engine cannot host (the ssm and hybrid
families: zamba2-7b, mamba2-130m; moe with leading dense blocks:
kimi-k2-1t-a32b) fall back, as there, to the static-wave
``Server`` (``train/server.py``) at the arch's own weight and KV precision,
greedy only: sampling flags exit with a message naming the static-wave
fallback, and the report has the JAX launcher's keys plus ``device``.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4, help="concurrent slots")
    ap.add_argument("--page-size", type=int, default=16, help="KV page tokens")
    ap.add_argument("--w-bits", type=int, default=0, help="0 = arch default")
    ap.add_argument(
        "--precision-mix", default="",
        help="comma-separated w_bits cycled over requests, e.g. '4,8'",
    )
    ap.add_argument("--kv-bits", type=int, default=0, help="0 = arch default")
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument(
        "--shared-prefix", type=int, default=0, metavar="N",
        help="first N prompt tokens shared by every request (system prompt)",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=32,
        help="max prompt tokens prefilled per engine step (chunked prefill)",
    )
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative draft tokens per round (0 = plain decode)")
    ap.add_argument("--draft-bits", type=int, default=4, choices=(4, 8, 16),
                    help="weight precision of the speculative draft passes")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits before sampling (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts; request i samples "
                    "with seed + i")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token id: requests finish on emitting it")
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine, resolve_device
    from repro_torch.serve.outputs import GenerationOutput
    from repro_torch.serve.params import PrecisionParams, SamplingParams
    from repro_torch.train.server import engine_family

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if not engine_family(arch):
        return _serve_waves(args, arch)
    if args.no_quantize:
        mix = [16]
    elif args.precision_mix:
        mix = [int(b) for b in args.precision_mix.split(",")]
    else:
        mix = [args.w_bits or arch.serve_w_bits]
    kv_bits = args.kv_bits or arch.serve_kv_bits
    prompt = _prompt_maker(args, arch)

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(arch, gen)
    max_len = arch.prefix_len + args.prompt_len + args.new_tokens + 8

    pages_per_slot = -(-max_len // args.page_size)
    engine = ServeEngine(
        arch, params,
        max_slots=args.batch_size,
        num_pages=args.batch_size * pages_per_slot,
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        enable_prefix_cache=not args.no_prefix_cache,
        spec_k=args.spec_k,
        draft_bits=args.draft_bits,
        device=device,
    )
    reqs = [
        engine.submit(
            prompt(),
            SamplingParams(temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=args.seed + i,
                           max_new_tokens=args.new_tokens, eos_id=args.eos_id),
            PrecisionParams(w_bits=mix[i % len(mix)], kv_bits=kv_bits),
        )
        for i in range(args.requests)
    ]
    outputs: dict[int, GenerationOutput] = {}
    stream_events = 0
    for ev in engine.generate(reqs):
        if isinstance(ev, GenerationOutput):
            outputs[ev.rid] = ev
        else:
            stream_events += 1
    stats = engine.stats
    ttfts = sorted(stats.ttfts)
    outs = [outputs[r.rid] for r in reqs]
    report = {
        "arch": arch.name,
        "device": str(device),
        "w_bits_mix": mix,
        "kv_bits": kv_bits,
        "requests": len(reqs),
        "shared_prefix": args.shared_prefix,
        "temperature": args.temperature,
        "top_k": args.top_k,
        "top_p": args.top_p,
        "seed": args.seed,
        "tokens_out": stats.tokens_out,
        "stream_events": stream_events,
        "prefill_s": stats.prefill_s,
        "prefill_chunks": stats.prefill_chunks,
        "decode_s": stats.decode_s,
        "decode_tok_per_s": stats.decode_tok_per_s,
        "ttft_ms_first": ttfts[0] * 1e3 if ttfts else None,
        "ttft_ms_last": ttfts[-1] * 1e3 if ttfts else None,
        "prefix_hit_rate": stats.prefix_hit_rate,
        "prefix_hit_tokens": stats.prefix_hit_tokens,
        "decode_group_calls": {f"w{w}kv{k}": n for (w, k), n in stats.group_calls.items()},
        "mixed_precision_steps": stats.mixed_precision_steps,
        "mean_batch_occupancy": stats.mean_batch_occupancy,
        "preemptions": stats.preemptions,
        "spec_k": args.spec_k,
        "spec_rounds": stats.spec_rounds,
        "spec_accept_rate": stats.spec_accept_rate,
        "finish_reasons": [o.finish_reason for o in outs],
        "outputs": [list(o.tokens[:16]) for o in outs],
    }
    print(json.dumps(report, indent=1))
    return report


def _prompt_maker(args, arch):
    """Random prompts from ``--seed``: the first ``--shared-prefix`` tokens
    common to every request."""
    import numpy as np

    if args.shared_prefix >= args.prompt_len:
        raise SystemExit("--shared-prefix must be < --prompt-len")
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, arch.vocab, args.shared_prefix).astype(np.int32)

    def prompt() -> np.ndarray:
        tail = rng.integers(0, arch.vocab, args.prompt_len - args.shared_prefix)
        return np.concatenate([shared, tail.astype(np.int32)])

    return prompt


def _serve_waves(args, arch) -> dict:
    """The static-wave fallback: recurrent-cache archs and MoE with leading
    dense blocks, greedy only."""
    import torch

    from repro_torch.models import transformer as model_lib
    from repro_torch.device import resolve_device
    from repro_torch.train.server import Request, Server

    if args.temperature or args.top_k or args.top_p < 1.0:
        raise SystemExit(
            f"--temperature/--top-k/--top-p are not supported for {arch.name} "
            f"({arch.family!r}): the static-wave fallback decodes greedily"
        )
    prompt = _prompt_maker(args, arch)
    device = resolve_device(args.device)
    params = model_lib.init_params(arch, torch.Generator(device=device).manual_seed(args.seed))
    max_len = arch.prefix_len + args.prompt_len + args.new_tokens + 8
    srv = Server(arch, params, batch_size=args.batch_size, max_len=max_len,
                 quantize=not args.no_quantize, device=device)
    del params
    reqs = [Request(rid=i, prompt=prompt(), max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    srv.serve(reqs)
    stats = srv.stats
    report = {
        "arch": arch.name,
        "device": str(device),
        "scheduler": "static-wave (family not supported by paged engine)",
        "w_bits": srv.w_bits,
        "requests": len(reqs),
        "tokens_out": stats.tokens_out,
        "prefill_s": stats.prefill_s,
        "decode_s": stats.decode_s,
        "decode_tok_per_s": stats.tokens_out / max(stats.decode_s, 1e-9),
        "outputs": [r.out_tokens[:16] for r in reqs],
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
