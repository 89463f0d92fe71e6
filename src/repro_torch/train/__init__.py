"""Training of the port (``repro/train``): the train step and the
``Trainer`` with guided HBM / pinned-host tiering of parameter and moment
groups."""

from .step import StepConfig, make_train_step, value_and_grad
from .trainer import Trainer, TrainerConfig

__all__ = ["StepConfig", "Trainer", "TrainerConfig", "make_train_step",
           "value_and_grad"]
