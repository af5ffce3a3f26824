"""Drafter training loop."""
from repro_torch.training.trainer import Trainer, TrainConfig

__all__ = ["Trainer", "TrainConfig"]
