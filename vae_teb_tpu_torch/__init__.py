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
prefetch), `cli` (train, build-data, stats, pack-data), `convert` (flax
checkpoint -> state_dict), `init` (seeded initialization) and `serve`
(InferenceServer, the production frontend).
"""

from .init import init_parameters
from .models import SeqVaeTeb
from .ops import PhaseScattering1D
from .serve import InferenceServer, WindowFrontend, production_frontend
from .train import Trainer, TrainerConfig

__all__ = ["InferenceServer", "PhaseScattering1D", "SeqVaeTeb", "Trainer",
           "TrainerConfig", "WindowFrontend", "init_parameters",
           "production_frontend"]
