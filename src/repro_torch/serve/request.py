"""Request lifecycle for the continuous-batching engine (port of
``repro/serve/request.py``).

A request carries its own precision choice: ``w_bits`` selects which
quantized weight set (W4/W8 via ``models.transformer.quantize_params``, 16 =
raw weights) its kernel calls run against, ``kv_bits`` selects the KV-cache
payload (4/8 = int + per-(token, head) scales, 16 = model dtype).  The
engine groups same-``group_key`` requests into one batched call per decode
step, and flattens ``serve/params.py``'s structured knobs onto the request
at ``submit()``.

Termination: a request finishes when it has emitted ``max_new_tokens``
(``finish_reason == "length"``), or the moment it emits ``eos_id`` / any
token in ``stop_tokens`` (``"stop"``, token kept).  A request whose context
can never fit the page pool is FAILED (``"failed"``) with ``error`` set.
Recompute-style preemption is safe for greedy decoding: a preempted request
re-prefills ``prompt + out_tokens[:-1]`` and continues deterministically.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"  # rejected at admission (e.g. context can never fit)


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    w_bits: int = 8  # weight precision for this request's kernel calls
    kv_bits: int = 8  # KV-cache payload precision (8=int8+scales, 16=bf16)
    eos_id: int | None = None  # finish on emitting this token
    stop_tokens: tuple[int, ...] = ()  # additional stop token ids
    spec_k: int = 0  # speculative draft tokens per round (0 = plain decode)
    draft_bits: int = 4  # weight precision of the speculative draft passes
    temperature: float = 0.0  # 0 = greedy argmax; > 0 samples
    top_k: int = 0  # keep k highest logits (0 = disabled)
    top_p: float = 1.0  # nucleus mass (1.0 = disabled)
    seed: int = 0  # per-request PRNG seed (position-keyed, see params.py)
    arrival: int = 0  # engine-assigned admission-order ticket (FCFS key)
    state: RequestState = RequestState.WAITING
    out_tokens: list[int] = field(default_factory=list)
    cache_len: int = 0  # tokens currently materialized in the KV cache
    preemptions: int = 0
    submit_ts: float = 0.0  # perf_counter at submit (TTFT reference point)
    ttft: float | None = None  # submit -> first output token, seconds
    error: str | None = None  # set when state is FAILED
    finish_reason: Optional[str] = None  # "stop" | "length" | "failed"
    spec_drafted: int = 0  # this request's drafted tokens (spec rounds)
    spec_accepted: int = 0  # drafts the verify accepted AND emission used

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def failed(self) -> bool:
        return self.state is RequestState.FAILED

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def group_key(self) -> tuple[int, int]:
        """(w_bits, kv_bits) — requests with equal keys batch together."""
        return (self.w_bits, self.kv_bits)

    def is_stop(self, tok: int) -> bool:
        """True when emitting ``tok`` must terminate the request."""
        return (self.eos_id is not None and tok == self.eos_id) or (
            tok in self.stop_tokens
        )

    def feed_tokens(self) -> np.ndarray:
        """Tokens a (re-)prefill must materialize in the cache: the prompt
        plus every generated token already *fed* back to the model (all but
        the newest, which the next decode step feeds)."""
        if self.out_tokens:
            return np.concatenate(
                [self.prompt, np.asarray(self.out_tokens[:-1], np.int32)]
            )
        return self.prompt
