"""Synchronous serving facade (port of ``repro/train/server.py``).

Hand a ``Server`` a list of ``Request``s and get them back completed.  The
families the paged engine hosts (dense, vlm, audio, and moe without leading
dense blocks) go to the port's ``ServeEngine``.  Every other family (ssm and hybrid recurrent
caches, and moe with leading dense blocks such as kimi-k2, whose unstacked
prefix the paged engine does not host) is served by the static-wave
scheduler over ``models.transformer``'s
contiguous-cache ``prefill`` / ``decode_step``: waves of ``batch_size``
requests, prompts left-padded with token 0 to a common length, one position
shared by the wave, greedy argmax, each request's first token from the
prefill logits and each decode step feeding the newest token back.

In place of the JAX ``Server``'s jitted ``_decode``, a wave's decode step
and its argmax run as one captured step (``serve/graphs.py``), keyed by
(cfg, B, max_len): on the card a CUDA graph captured on first use and
replayed after, eagerly under ``graphs.disable_capture()`` and on the CPU.
Its cache is the Server's own, one per wave size, which every wave's
``prefill`` refills in place, since a captured step reads it by address.
The wave's tokens stay on the device, in a [B, max_new] buffer read back
once at the wave's end.  The one-shot prefill of a wave (the JAX
``Server._prefill``) runs eagerly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as model_lib
from repro_torch.serve import graphs
from repro_torch.serve.engine import ServeEngine, _to_device
from repro_torch.serve.params import PrecisionParams, SamplingParams


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0
    tokens_out: int = 0


def engine_family(cfg: ArchConfig) -> bool:
    """The JAX package's ``ServeEngine.supports``: the families its paged
    engine hosts.  Everything else takes the static waves."""
    return cfg.family in ("dense", "vlm", "audio", "moe") and not (
        cfg.family == "moe" and cfg.first_dense
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Blocking facade.  ``batch_size`` bounds the requests served at once
    (engine slots, or the wave size); ``max_len`` sizes the cache of every
    slot.  Runs on the card unless ``device`` names another."""

    def __init__(
        self,
        arch: ArchConfig,
        params,
        *,
        batch_size: int = 4,
        max_len: int = 512,
        quantize: bool = True,
        page_size: int = 16,
        device=None,
    ):
        self.arch = arch
        self.batch_size = batch_size
        self.max_len = max_len
        self.w_bits = arch.serve_w_bits if quantize else 16
        self.device = resolve_device(device)
        self.engine = None
        if engine_family(arch):
            pages_per_slot = -(-max_len // page_size)
            self.engine = ServeEngine(
                arch, params, max_slots=batch_size,
                num_pages=batch_size * pages_per_slot, page_size=page_size,
                device=self.device,
            )
        else:
            params = _to_device(params, self.device)
            self._params = (model_lib.quantize_params(params, arch.serve_w_bits)
                            if quantize else params)
            self.graphs = graphs.StepGraphs(self.device)  # the captured wave step
            self._caches: dict[int, dict] = {}  # wave size -> its decode cache
        self.stats = ServeStats()

    @property
    def params(self):
        """Weights actually served (quantized view when enabled)."""
        if self.engine is not None:
            return self.engine.params_for(self.w_bits)
        return self._params

    def serve(self, requests: list[Request], greedy: bool = True) -> list[Request]:
        if not greedy:
            raise NotImplementedError("decoding is greedy-only")
        if self.engine is None:
            return self._serve_waves(requests)
        precision = PrecisionParams(w_bits=self.w_bits)
        handles = [
            self.engine.submit(r.prompt, SamplingParams(max_new_tokens=r.max_new_tokens),
                               precision, rid=r.rid)
            for r in requests
        ]
        self.engine.run()
        for req, h in zip(requests, handles):
            req.out_tokens = list(h.out_tokens)
            req.done = h.done
        es = self.engine.stats
        self.stats = ServeStats(prefill_s=es.prefill_s, decode_s=es.decode_s,
                                decode_steps=es.decode_steps, tokens_out=es.tokens_out)
        return requests

    # ------------------------------------------------- static-wave fallback
    def _make_batch(self, reqs: list[Request]) -> dict:
        s = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt  # left-pad to align last token
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    def prefill_wave(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Prefill a wave (``batch["tokens"] [B, S]``) into the Server's
        cache for B; returns (first tokens [B, 1], that cache)."""
        b = batch["tokens"].shape[0]
        if b not in self._caches:
            self._caches[b] = model_lib.init_cache(self.arch, b, self.max_len, self.device)
        logits, cache = model_lib.prefill(self._params, batch, self.arch, self.max_len,
                                          cache=self._caches[b])
        return logits.argmax(dim=-1, keepdim=True), cache

    def decode_wave(self, tok: torch.Tensor) -> torch.Tensor:
        """One decode step of a wave and its argmax, as a captured step:
        tokens [B, 1] -> next tokens [B, 1], the Server's cache for B (the
        last ``prefill_wave``'s) advanced in place."""
        cache = self._caches[tok.shape[0]]

        def step(tok):
            logits, _ = model_lib.decode_step(self._params, tok, cache, self.arch)
            return logits.argmax(dim=-1, keepdim=True)

        key = graphs.step_key("wave_decode", self.arch, (self.w_bits, self.max_len), (tok,))
        return self.graphs.run(key, step, (tok,))

    def _serve_waves(self, requests: list[Request]) -> list[Request]:
        """Waves of batch_size requests with one shared position."""
        pending = list(requests)
        while pending:
            wave = pending[: self.batch_size]
            pending = pending[self.batch_size:]
            t0 = time.perf_counter()
            tok, _ = self.prefill_wave(self._make_batch(wave))
            _sync(self.device)
            self.stats.prefill_s += time.perf_counter() - t0
            max_new = max(r.max_new_tokens for r in wave)
            t0 = time.perf_counter()
            out = torch.empty((len(wave), max_new), dtype=tok.dtype, device=self.device)
            for i in range(max_new):
                out[:, i] = tok[:, 0]
                tok = self.decode_wave(tok)
                self.stats.decode_steps += 1
            picks = out.tolist()  # the wave's one read-back
            self.stats.decode_s += time.perf_counter() - t0
            for i, r in enumerate(wave):
                r.out_tokens.extend(picks[i][: max(r.max_new_tokens - len(r.out_tokens), 0)])
                r.done = True
                self.stats.tokens_out += len(r.out_tokens)
        return requests
