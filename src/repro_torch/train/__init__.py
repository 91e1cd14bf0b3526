"""Serving facade (``train/server.py``) and the training loop
(``train/trainer.py``), named as in ``repro``."""
from repro_torch.train.trainer import Trainer, TrainConfig, make_train_step

__all__ = ["Trainer", "TrainConfig", "make_train_step"]
