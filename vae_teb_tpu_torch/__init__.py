"""PyTorch/CUDA port of vae_teb_tpu for NVIDIA Hopper: serving, training
and dataset building.

The JAX package `vae_teb_tpu` is the reference; this package imports
neither JAX nor flax. Layout mirrors it: `ops` (frontend:
scattering to order 2, exact and reduced-rate phase harmonics), `models`
(blocks, SeqVaeTeb, the bf16 compute policy), `kernels` (hand-written CUDA
kernels and their plain PyTorch versions), `train` (schedules, the clipped
AdamW chain, gradient accumulation, Trainer with fit, checkpoints,
callbacks, run config), `data` (the HDF5 schema, synthetic windows and the
ETL, statistics, normalization, the HDF5 reader, the packed window store,
prefetch), `eval` (ModelEvaluator and the evaluation suite), `cli`
(train, test, export, build-data, stats, pack-data), `convert` (flax
checkpoint -> state_dict), `init` (seeded initialization) and `serve`
(InferenceServer, the production frontend, StreamingSession and the
`torch.export` serving artifacts).
"""

from .init import init_parameters
from .models import SeqVaeTeb
from .ops import PhaseScattering1D
from .serve import (InferenceServer, StreamingSession, WindowFrontend,
                    export_inference, export_source_stream, load_artifact,
                    production_frontend, save_artifact)
from .train import Trainer, TrainerConfig

__all__ = ["InferenceServer", "PhaseScattering1D", "SeqVaeTeb",
           "StreamingSession", "Trainer", "TrainerConfig", "WindowFrontend",
           "export_inference", "export_source_stream", "init_parameters",
           "load_artifact", "production_frontend", "save_artifact"]
