"""Training: schedules, the clipped AdamW chain and the train/eval step."""

from .schedules import (ClippedAdamW, beta_schedule, cosine_warm_restarts,
                        make_optimizer)
from .trainer import Trainer, TrainerConfig

__all__ = ["ClippedAdamW", "Trainer", "TrainerConfig", "beta_schedule",
           "cosine_warm_restarts", "make_optimizer"]
