"""PyTorch/CUDA port of vae_teb_tpu for NVIDIA Hopper: serving and
training.

The JAX package `vae_teb_tpu` is the reference; this package imports
neither JAX nor flax. Layout mirrors it: `ops` (frontend), `models`
(blocks, SeqVaeTeb, the bf16 compute policy), `kernels` (hand-written CUDA
kernels and their plain PyTorch versions), `train` (schedules, the clipped
AdamW chain, gradient accumulation, Trainer with fit, checkpoints,
callbacks, run config), `data` (normalization, the HDF5 reader, the packed
window store, prefetch), `cli` (the train command), `convert` (flax
checkpoint -> state_dict), `init` (seeded initialization) and `serve`
(InferenceServer).
"""

from .init import init_parameters
from .models import SeqVaeTeb
from .ops import PhaseScattering1D
from .serve import InferenceServer, WindowFrontend
from .train import Trainer, TrainerConfig

__all__ = ["InferenceServer", "PhaseScattering1D", "SeqVaeTeb", "Trainer",
           "TrainerConfig", "WindowFrontend", "init_parameters"]
