"""Training loop — counterpart of ``repro.train`` (auto cross-pod mode, no checkpointing yet)."""

from .step import build_train_step, init_state
from .trainer import FaultInjector, Trainer, TrainerConfig

__all__ = ["build_train_step", "init_state", "Trainer", "TrainerConfig", "FaultInjector"]
