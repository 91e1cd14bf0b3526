from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adafactor,
    adamw,
    adamw8bit,
    make_optimizer,
)
from repro_torch.optim.schedules import cosine_schedule

__all__ = ["OptState", "Optimizer", "adamw", "adafactor", "adamw8bit", "make_optimizer",
           "cosine_schedule"]
