"""Training loop, checkpointing."""

from .checkpoint import CheckpointManager
from .trainer import StragglerMonitor, TrainConfig, Trainer
