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
Weights are random, drawn from ``--seed`` with a ``torch.Generator``.

This slice serves greedy decoding without speculation: ``--temperature``
above 0, ``--top-k``, ``--top-p`` below 1 and ``--spec-k`` above 0 raise
``NotImplementedError`` naming the ROADMAP item, as do archs the port's
engine does not serve.
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
                    help="speculative draft tokens per round (not ported: must be 0)")
    ap.add_argument("--draft-bits", type=int, default=4, choices=(4, 8, 16),
                    help="draft weight precision of speculative decoding (not ported)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (not ported: must be 0, greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token id: requests finish on emitting it")
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as model_lib
    from repro_torch.serve.engine import ServeEngine, resolve_device
    from repro_torch.serve.outputs import GenerationOutput
    from repro_torch.serve.params import PrecisionParams, SamplingParams

    if args.temperature > 0 or args.top_k or args.top_p < 1.0:
        raise NotImplementedError(
            "--temperature/--top-k/--top-p: sampling is not ported yet (ROADMAP: sampling)"
        )
    if args.spec_k:
        raise NotImplementedError(
            "--spec-k: speculative decoding is not ported yet (ROADMAP: spec decode)"
        )
    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if args.no_quantize:
        mix = [16]
    elif args.precision_mix:
        mix = [int(b) for b in args.precision_mix.split(",")]
    else:
        mix = [args.w_bits or arch.serve_w_bits]
    kv_bits = args.kv_bits or arch.serve_kv_bits
    if args.shared_prefix >= args.prompt_len:
        raise SystemExit("--shared-prefix must be < --prompt-len")

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(arch, gen)
    max_len = args.prompt_len + args.new_tokens + 8
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, arch.vocab, args.shared_prefix).astype(np.int32)

    def prompt() -> np.ndarray:
        tail = rng.integers(0, arch.vocab, args.prompt_len - args.shared_prefix)
        return np.concatenate([shared, tail.astype(np.int32)])

    pages_per_slot = -(-max_len // args.page_size)
    engine = ServeEngine(
        arch, params,
        max_slots=args.batch_size,
        num_pages=args.batch_size * pages_per_slot,
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        enable_prefix_cache=not args.no_prefix_cache,
        device=device,
    )
    reqs = [
        engine.submit(
            prompt(),
            SamplingParams(max_new_tokens=args.new_tokens, eos_id=args.eos_id),
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
        "finish_reasons": [o.finish_reason for o in outs],
        "outputs": [list(o.tokens[:16]) for o in outs],
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
