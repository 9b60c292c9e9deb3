"""Training: optimizer, trainer and the federation-backed checkpointer
(the reference's ``train/step.py``, its sharded step functions, is not
ported yet)."""
from .checkpoint import FederatedCheckpointer
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .trainer import FailureInjector, Trainer, TrainerReport

__all__ = ["FederatedCheckpointer", "AdamWConfig", "adamw_update",
           "init_opt_state", "FailureInjector", "Trainer", "TrainerReport"]
