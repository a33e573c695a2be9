"""PyTorch/CUDA port of vae_teb_tpu's serving path for NVIDIA Hopper.

The JAX package `vae_teb_tpu` is the reference; this package imports
neither JAX nor flax. Layout mirrors it: `ops` (frontend), `models`
(blocks, SeqVaeTeb), `kernels` (hand-written CUDA kernels and their plain
PyTorch versions), `convert` (flax checkpoint -> state_dict), `init`
(seeded initialization) and `serve` (InferenceServer).
"""

from .init import init_parameters
from .models import SeqVaeTeb
from .ops import PhaseScattering1D
from .serve import InferenceServer

__all__ = ["InferenceServer", "PhaseScattering1D", "SeqVaeTeb",
           "init_parameters"]
