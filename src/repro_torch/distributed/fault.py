"""Fault tolerance for long-running jobs (a copy of
``repro/distributed/fault.py``, which is plain Python).

A lost or slow worker stalls a synchronous job, so resilience is: (a) never
lose more than a bounded amount of work (checkpoint cadence and atomicity,
``checkpoint/manager.py``), (b) detect the stall quickly (this module's
step-deadline watchdog), (c) restart and replay deterministically (the data
pipeline is keyed by step).

``StepMonitor`` tracks an EMA of step wall-time and flags steps exceeding
``deadline_factor`` x EMA: the straggler signal.  ``run_with_restarts`` is
the retry/resume driver (tests inject failures and assert that the driver
resumes from the last checkpoint with identical results).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StepMonitor:
    ema_decay: float = 0.9
    deadline_factor: float = 3.0
    warmup_steps: int = 3
    ema: Optional[float] = None
    steps_seen: int = 0
    stragglers: list[int] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler (deadline exceeded)."""
        self.steps_seen += 1
        if self.ema is None:
            self.ema = seconds
            return False
        is_straggler = (
            self.steps_seen > self.warmup_steps
            and seconds > self.deadline_factor * self.ema
        )
        if is_straggler:
            self.stragglers.append(step)
        else:  # stragglers do not poison the EMA
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * seconds
        return is_straggler


def run_with_restarts(
    train_fn: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, Exception], None]] = None,
) -> int:
    """Crash-resilient driver: ``train_fn(start_step) -> final_step`` runs the
    loop from its last checkpoint; any exception triggers restore + retry
    (bounded).  Used by launch/train.py and the fault-injection tests."""
    restarts = 0
    start_step = 0
    while True:
        try:
            return train_fn(start_step)
        except Exception as e:  # noqa: BLE001 — deliberate: any step failure
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            # train_fn re-reads its checkpoint manager for the resume step
            start_step = -1  # sentinel: resume from latest checkpoint
            time.sleep(0.01)
