"""Training: schedules, the clipped AdamW chain and gradient accumulation,
the Trainer (steps and fit), the classifier trainer and its k-fold
workflow, checkpoints and checkpoint surgery, callbacks and the run
config."""

from .callbacks import (Callback, HistoryCallback, LossCurveCallback,
                        MemoryMonitorCallback, ReconstructionPlotCallback)
from .checkpoint import Checkpointer, transfer_params
from .classifier import (ClassifierConfig, ClassifierTrainer,
                         train_and_test_folds)
from .config import (CheckpointConfig, DatasetConfig, ModelConfig, RunConfig,
                     load_config, save_config)
from .schedules import (ClippedAdamW, MultiSteps, beta_schedule,
                        cosine_warm_restarts, global_norm, make_optimizer)
from .trainer import Trainer, TrainerConfig

__all__ = ["Callback", "CheckpointConfig", "Checkpointer", "ClassifierConfig",
           "ClassifierTrainer", "ClippedAdamW",
           "DatasetConfig", "HistoryCallback", "LossCurveCallback",
           "MemoryMonitorCallback", "ModelConfig", "MultiSteps",
           "ReconstructionPlotCallback", "RunConfig", "Trainer",
           "TrainerConfig", "beta_schedule", "cosine_warm_restarts",
           "global_norm", "load_config", "make_optimizer", "save_config",
           "train_and_test_folds", "transfer_params"]
