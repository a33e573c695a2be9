"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from .wavefront import wavefront_fwd
from .wavefront_ref import wavefront_fwd_plain

__all__ = ["wavefront_fwd", "wavefront_fwd_plain"]
