"""Training: schedules, the clipped AdamW chain and gradient accumulation,
the Trainer (steps and fit), checkpoints, callbacks and the run config."""

from .callbacks import (Callback, HistoryCallback, LossCurveCallback,
                        MemoryMonitorCallback, ReconstructionPlotCallback)
from .checkpoint import Checkpointer
from .config import (CheckpointConfig, DatasetConfig, ModelConfig, RunConfig,
                     load_config, save_config)
from .schedules import (ClippedAdamW, MultiSteps, beta_schedule,
                        cosine_warm_restarts, global_norm, make_optimizer)
from .trainer import Trainer, TrainerConfig

__all__ = ["Callback", "CheckpointConfig", "Checkpointer", "ClippedAdamW",
           "DatasetConfig", "HistoryCallback", "LossCurveCallback",
           "MemoryMonitorCallback", "ModelConfig", "MultiSteps",
           "ReconstructionPlotCallback", "RunConfig", "Trainer",
           "TrainerConfig", "beta_schedule", "cosine_warm_restarts",
           "global_norm", "load_config", "make_optimizer", "save_config"]
