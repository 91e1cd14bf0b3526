"""Fault tolerance of the training loop; the multi-device modules of
``repro.distributed`` (sharding, collectives, pipeline, elastic) are not
ported yet."""
from repro_torch.distributed.fault import StepMonitor, run_with_restarts

__all__ = ["StepMonitor", "run_with_restarts"]
