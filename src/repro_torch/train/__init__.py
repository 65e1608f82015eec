"""Training loop — counterpart of ``repro.train`` (auto cross-pod mode), with checkpoints through SCISPACE."""

from .checkpoint import CheckpointInfo, CheckpointManager
from .step import build_train_step, init_state
from .trainer import FaultInjector, NodeFailure, Trainer, TrainerConfig

__all__ = ["build_train_step", "init_state", "Trainer", "TrainerConfig", "FaultInjector", "NodeFailure",
           "CheckpointManager", "CheckpointInfo"]
