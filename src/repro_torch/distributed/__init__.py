"""Distributed runtime (port of ``repro.distributed``): sharding rules
(``sharding``), int8 compressed collectives (``collectives``), pipeline
stages (``pipeline``), elastic resharding (``elastic``), over
``torch.distributed``; and fault tolerance of the training loop
(``fault``)."""
from repro_torch.distributed.fault import StepMonitor, run_with_restarts

__all__ = ["StepMonitor", "run_with_restarts"]
