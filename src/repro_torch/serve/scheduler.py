"""Admission / eviction policy for the continuous-batching engine.

FCFS with head-of-line blocking: the waiting queue is kept in arrival order
and admission always considers the *head* first, stopping at the first
request that does not fit (no bypass).  That is the no-starvation guarantee —
a large old request can never be overtaken indefinitely by small young ones.

Eviction is youngest-first (max arrival ticket): when the page pool cannot
grow a running request's cache, the most recently admitted request is
preempted — its pages are freed and it re-enters the waiting queue in
arrival order, so it is also the first to come back.  Preempting the
youngest bounds wasted work and, combined with FCFS admission, guarantees
the oldest request always makes progress.
"""
from __future__ import annotations

import bisect
from typing import Callable, Optional

from repro_torch.serve.request import RequestState, ServeRequest


class Scheduler:
    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.waiting: list[ServeRequest] = []  # kept sorted by arrival
        self.running: list[ServeRequest] = []

    @property
    def free_slots(self) -> int:
        return self.max_slots - len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------- admission
    def submit(self, req: ServeRequest) -> None:
        """Enqueue a new or preempted request, keeping arrival order."""
        req.state = RequestState.WAITING
        bisect.insort(self.waiting, req, key=lambda r: r.arrival)

    def admit(self, fits: Callable[[ServeRequest], bool]) -> list[ServeRequest]:
        """Move waiting requests into the running set, FCFS.

        ``fits(req)`` answers whether the KV pool can hold req's prefill.
        Stops at the first request that doesn't fit (head-of-line blocking —
        the no-starvation invariant), or when slots run out.
        """
        admitted: list[ServeRequest] = []
        while self.waiting and self.free_slots > 0 and fits(self.waiting[0]):
            req = self.waiting.pop(0)
            req.state = RequestState.RUNNING
            self.running.append(req)
            admitted.append(req)
        return admitted

    # -------------------------------------------------------------- eviction
    def pick_victim(self, kv_bits: Optional[int] = None) -> Optional[ServeRequest]:
        """Youngest running request (optionally restricted to one KV pool)."""
        pool = [
            r for r in self.running if kv_bits is None or r.kv_bits == kv_bits
        ]
        return max(pool, key=lambda r: r.arrival) if pool else None

    def preempt(self, req: ServeRequest) -> None:
        """Remove req from the running set and requeue it (recompute-style)."""
        self.running.remove(req)
        req.preemptions += 1
        req.cache_len = 0
        self.submit(req)

    def finish(self, req: ServeRequest) -> None:
        self.running.remove(req)
        req.state = RequestState.FINISHED
