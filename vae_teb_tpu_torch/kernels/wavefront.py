"""Dispatch for the forward wavefront LSTM recurrence.

`wavefront_fwd` picks by the device of its inputs: a CPU tensor takes the
plain PyTorch version (`wavefront_ref.wavefront_fwd_plain`), a CUDA tensor
launches the hand-written kernel (`wavefront_fwd.cu`), anything else
raises. Each kernel launch adds one to `wavefront_fwd.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .wavefront_ref import wavefront_fwd_plain

_ENTRY = {torch.float32: "wavefront_fwd_f32",
          torch.bfloat16: "wavefront_fwd_bf16"}
_MAX_UH = 1024   # one thread per state column, one block per batch row


def _kernel(dtype: torch.dtype):
    fn = getattr(build.load("wavefront_fwd.cu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wavefront_fwd(W_eff: torch.Tensor, b_packed: torch.Tensor,
                  xs_wave: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  lvec: torch.Tensor, S: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward wavefront: (h_seq (K, B, UH), h_fin, c_fin (B, UH)).

    Arguments as in `wavefront_fwd_plain`. On CUDA all tensors must be
    contiguous, on one device, of one storage dtype (float32 or bfloat16),
    with lvec int32; no gradient flows, because the backward kernel is not
    ported yet.
    """
    device = xs_wave.device
    if device.type == "cpu":
        return wavefront_fwd_plain(W_eff, b_packed, xs_wave, h0, c0, lvec, S)
    if device.type != "cuda":
        raise ValueError(f"wavefront_fwd has no implementation for {device}")
    tensors = (W_eff, b_packed, xs_wave, h0, c0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(
            "the wavefront backward kernel is not ported yet: call the CUDA "
            "forward under torch.no_grad() or torch.inference_mode()")
    dtype = xs_wave.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"wavefront_fwd takes float32 or bfloat16, got {dtype}")
    if any(x.dtype != dtype for x in tensors) or lvec.dtype != torch.int32:
        raise TypeError("wavefront_fwd needs one storage dtype for W_eff, "
                        "b_packed, xs_wave, h0, c0 and an int32 lvec")
    if any(x.device != device for x in tensors + (lvec,)):
        raise ValueError("wavefront_fwd inputs lie on different devices")
    if not all(x.is_contiguous() for x in tensors + (lvec,)):
        raise ValueError("wavefront_fwd needs contiguous inputs")
    K, B, G = xs_wave.shape
    UH = G // 4
    U = lvec.numel()
    if G != 4 * UH or UH % U or not 0 < UH <= _MAX_UH:
        raise ValueError(f"wavefront_fwd: bad packed width 4*UH={G} for "
                         f"{U} units (UH at most {_MAX_UH})")
    if (W_eff.shape != (UH, G) or b_packed.shape != (G,)
            or h0.shape != (B, UH) or c0.shape != (B, UH)):
        raise ValueError("wavefront_fwd: W_eff, b_packed, h0 or c0 does not "
                         f"match xs_wave {tuple(xs_wave.shape)}")
    if not 0 < B < 2 ** 31 or K < 1:
        raise ValueError(f"wavefront_fwd: bad batch {B} or step count {K}")
    h_seq = torch.empty((K, B, UH), dtype=dtype, device=device)
    h_fin = torch.empty((B, UH), dtype=dtype, device=device)
    c_fin = torch.empty((B, UH), dtype=dtype, device=device)
    with torch.cuda.device(device):
        err = _kernel(dtype)(
            W_eff.data_ptr(), b_packed.data_ptr(), xs_wave.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), lvec.data_ptr(), h_seq.data_ptr(),
            h_fin.data_ptr(), c_fin.data_ptr(), K, B, UH, UH // U, S,
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"wavefront_fwd kernel launch failed: CUDA error {err}")
    wavefront_fwd.launches += 1
    return h_seq, h_fin, c_fin


wavefront_fwd.launches = 0
