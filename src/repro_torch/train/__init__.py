"""Training substrate of the port (the JAX package's ``train``): atomic
async checkpoints, the fault-tolerant ``Trainer`` over the captured train
step, and the train step as a UTP task tree."""

from .checkpoint import Checkpointer
from .step_ops import UTPTrainStep
from .trainer import Trainer, TrainerConfig

__all__ = ["Checkpointer", "Trainer", "TrainerConfig", "UTPTrainStep"]
