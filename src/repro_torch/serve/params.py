"""Structured request parameters for the generation API (port of
``repro/serve/params.py``).

``SamplingParams`` is everything that shapes the *token stream*: how many
tokens, how they are chosen, and what terminates them.  ``PrecisionParams``
is everything that shapes the *compute*: which quantized weight set runs the
request's kernel calls, the KV-cache payload precision, and the speculative
decoding knobs.  Both are frozen, so one instance can be shared across many
``submit()`` calls.

Sampling is seeded and position-keyed: the token at stream position ``p``
is drawn with the key ``fold_in(fold_in(PRNGKey(seed), p), salt)``
(``kernels/ops.py::sample_keys``, the port's threefry bit-equal to
``jax.random``), so a fixed seed replays the same stream whatever the batch
composition or preemptions, and the JAX engine's stream too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_BITS = (4, 8, 16)


@dataclass(frozen=True)
class SamplingParams:
    """How a request's tokens are chosen and when the stream stops.

    temperature: 0.0 = greedy argmax (default); > 0 softmax-samples the
        (top-k/top-p masked) logits at ``logits / temperature``.
    top_k: keep only the k highest logits before sampling (0 = disabled).
    top_p: nucleus sampling — keep the smallest set of tokens whose
        cumulative probability reaches top_p (1.0 = disabled).
    seed: per-request sampling seed (position-keyed, see above).
    max_new_tokens: token budget; the request finishes when it is spent.
    eos_id / stop_tokens: emitting any of these finishes the request
        immediately (the stop token itself is kept in the output).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    stop_tokens: tuple[int, ...] = ()

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        if not 0 <= self.seed < 2**32:
            raise ValueError(
                f"seed must fit uint32 (0 <= seed < 2**32), got {self.seed}"
            )
        object.__setattr__(
            self, "stop_tokens", tuple(int(t) for t in self.stop_tokens)
        )

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclass(frozen=True)
class PrecisionParams:
    """Which compute path serves the request.

    ``None`` fields resolve to the engine's defaults at ``submit()`` time
    (``cfg.serve_w_bits`` / ``cfg.serve_kv_bits`` for the precisions, the
    engine's ``spec_k`` / ``draft_bits`` for speculation), so
    ``PrecisionParams()`` means "whatever the engine was configured with".

    w_bits: weight precision of the request's kernel calls (4 / 8 / 16).
    kv_bits: KV-cache payload precision (4 / 8 = int + scales, 16 = bf16).
    spec_k: speculative draft tokens per round (0 = plain decode).
    draft_bits: weight precision of the speculative draft passes.
    """

    w_bits: Optional[int] = None
    kv_bits: Optional[int] = None
    spec_k: Optional[int] = None
    draft_bits: Optional[int] = None

    def __post_init__(self):
        for name in ("w_bits", "kv_bits", "draft_bits"):
            val = getattr(self, name)
            if val is not None and val not in _BITS:
                raise ValueError(f"{name} must be one of {_BITS}, got {val}")
        if self.spec_k is not None and self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
