"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package registers the operators
`vae_teb_tpu_torch::wavefront_fwd`, `vae_teb_tpu_torch::upsample_linear2x`
and `vae_teb_tpu_torch::layer_norm`, which exported programs call."""

from .launches import add_launch_counts, launch_counts
from .layer_norm import (LayerNormFunction, layer_norm_bwd,
                         layer_norm_bwd_plain, layer_norm_fwd,
                         layer_norm_fwd_plain, layer_norm_op,
                         layer_norm_rows)
from .upsample import (LinearUpsampleFunction, linear_upsample,
                       upsample_linear2x_bwd, upsample_linear2x_bwd_plain,
                       upsample_linear2x_fwd, upsample_linear2x_fwd_plain,
                       upsample_linear2x_op)
from .wavefront import (WavefrontFunction, wavefront_bwd, wavefront_fwd,
                        wavefront_fwd_op, wavefront_recurrence)
from .wavefront_ref import wavefront_bwd_plain, wavefront_fwd_plain

__all__ = ["LayerNormFunction", "LinearUpsampleFunction", "WavefrontFunction",
           "add_launch_counts", "launch_counts", "layer_norm_bwd",
           "layer_norm_bwd_plain", "layer_norm_fwd", "layer_norm_fwd_plain",
           "layer_norm_op", "layer_norm_rows", "linear_upsample",
           "upsample_linear2x_bwd", "upsample_linear2x_bwd_plain",
           "upsample_linear2x_fwd",
           "upsample_linear2x_fwd_plain", "upsample_linear2x_op",
           "wavefront_bwd", "wavefront_bwd_plain",
           "wavefront_fwd", "wavefront_fwd_op", "wavefront_fwd_plain",
           "wavefront_recurrence"]
