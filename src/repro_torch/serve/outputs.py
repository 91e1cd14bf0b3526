"""Streaming output types for the generation API.

``ServeEngine.generate()`` yields one ``StreamEvent`` per emitted token, in
emission order, the moment the engine step that produced it completes —
callers stream tokens out while batch-mates are still decoding.  When a
request finishes (budget, stop token, or admission failure), its terminal
``GenerationOutput`` follows, carrying the whole stream plus the request's
latency/preemption/speculation accounting.

Events are append-only: preemption replays *compute* (the KV cache is
rebuilt) but never un-emits a token, so a consumer may act on every event as
it arrives.  Finish reasons:

* ``"stop"``   — the request emitted its ``eos_id`` or a ``stop_tokens``
  member (the stop token is the last token of the stream).
* ``"length"`` — the ``max_new_tokens`` budget is spent.
* ``"failed"`` — rejected at admission (e.g. the context can never fit the
  page pool); ``GenerationOutput.error`` says why and the stream is empty.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_FAILED = "failed"


@dataclass(frozen=True)
class StreamEvent:
    """One emitted token of one request's stream.

    ``index`` is the token's position in the output text (0 = first
    generated token); ``finish_reason`` is None mid-stream and set on the
    stream's final event."""

    rid: int
    token: int
    index: int
    finish_reason: Optional[str] = None

    @property
    def is_last(self) -> bool:
        return self.finish_reason is not None


@dataclass(frozen=True)
class GenerationOutput:
    """Terminal summary of one request, yielded after its last StreamEvent.

    ``ttft``: submit -> first token, seconds (None if the request failed
    before emitting).  ``spec_drafted`` / ``spec_accepted``: this request's
    own speculative-decoding accounting (0/0 for plain-decode requests)."""

    rid: int
    tokens: tuple[int, ...]
    finish_reason: str
    error: Optional[str] = None
    ttft: Optional[float] = None
    preemptions: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of this request's drafted tokens the verify accepted."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    @classmethod
    def from_request(cls, req) -> "GenerationOutput":
        """Build the terminal output for a FINISHED or FAILED ServeRequest."""
        return cls(
            rid=req.rid,
            tokens=tuple(req.out_tokens),
            finish_reason=req.finish_reason or (
                FINISH_FAILED if req.failed else FINISH_LENGTH
            ),
            error=req.error,
            ttft=req.ttft,
            preemptions=req.preemptions,
            spec_drafted=req.spec_drafted,
            spec_accepted=req.spec_accepted,
        )
