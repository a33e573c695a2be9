"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package registers the operator
`vae_teb_tpu_torch::wavefront_fwd`, which exported programs call."""

from .wavefront import (WavefrontFunction, add_launch_counts, launch_counts,
                        wavefront_bwd, wavefront_fwd, wavefront_fwd_op,
                        wavefront_recurrence)
from .wavefront_ref import wavefront_bwd_plain, wavefront_fwd_plain

__all__ = ["WavefrontFunction", "add_launch_counts", "launch_counts",
           "wavefront_bwd", "wavefront_bwd_plain",
           "wavefront_fwd", "wavefront_fwd_op", "wavefront_fwd_plain",
           "wavefront_recurrence"]
