"""Dispatch for the wavefront LSTM recurrences, and their autograd Function.

`wavefront_fwd` and `wavefront_bwd` pick by the device of their inputs: a
CPU tensor takes the plain PyTorch version (`wavefront_ref`), a CUDA tensor
launches the hand-written kernel (`wavefront_fwd.cu`, `wavefront_bwd.cu`),
anything else raises. Each kernel launch adds one to its wrapper's count:
`wavefront_fwd.launches` (serving forward), `wavefront_fwd.residual_launches`
(training forward, which also stores the residuals) and
`wavefront_bwd.launches`.

`wavefront_recurrence` is the differentiable recurrence the model calls:
the forward alone when no gradient is wanted, otherwise
`WavefrontFunction`, whose backward runs the reverse wavefront and forms
the weight gradients outside the recurrence, as the JAX package's custom VJP does
(`vae_teb_tpu/models/blocks.py::_wavefront_core`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .wavefront_ref import wavefront_bwd_plain, wavefront_fwd_plain

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_UH = 1024   # one thread per state column, one block per batch row


def _kernel(source: str, entry: str, n_ptr: int):
    fn = getattr(build.load(source), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, tensors, lvec: torch.Tensor, seq: torch.Tensor) -> None:
    """The CUDA wrappers' input contract: one storage dtype (float32 or
    bfloat16), an int32 lvec, one device, contiguous, a packed width 4UH
    that the units divide."""
    dtype = seq.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    if any(x.dtype != dtype for x in tensors) or lvec.dtype != torch.int32:
        raise TypeError(f"{name} needs one storage dtype for its float "
                        "inputs and an int32 lvec")
    if any(x.device != seq.device for x in tensors + (lvec,)):
        raise ValueError(f"{name} inputs lie on different devices")
    if not all(x.is_contiguous() for x in tensors + (lvec,)):
        raise ValueError(f"{name} needs contiguous inputs")
    K, B, G = seq.shape
    UH, U = G // 4, lvec.numel()
    if G != 4 * UH or UH % U or not 0 < UH <= _MAX_UH:
        raise ValueError(f"{name}: bad packed width 4*UH={G} for {U} units "
                         f"(UH at most {_MAX_UH})")
    if not 0 < B < 2 ** 31 or K < 1:
        raise ValueError(f"{name}: bad batch {B} or step count {K}")


def _device_type(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no implementation for {x.device}")
    return x.device.type


def wavefront_fwd(W_eff: torch.Tensor, b_packed: torch.Tensor,
                  xs_wave: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  lvec: torch.Tensor, S: int, with_residuals: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """Forward wavefront: (h_seq (K, B, UH), h_fin, c_fin (B, UH)), and with
    with_residuals also (gates_seq (K, B, 4UH), c_seq (K, B, UH)).

    Arguments as in `wavefront_fwd_plain`. On CUDA all tensors must be
    contiguous, on one device, of one storage dtype (float32 or bfloat16),
    with lvec int32. Records no autograd graph (see `wavefront_recurrence`).
    """
    if _device_type("wavefront_fwd", xs_wave) == "cpu":
        return wavefront_fwd_plain(W_eff, b_packed, xs_wave, h0, c0, lvec, S,
                                   with_residuals)
    tensors = (W_eff, b_packed, xs_wave, h0, c0)
    _check("wavefront_fwd", tensors, lvec, xs_wave)
    K, B, G = xs_wave.shape
    UH = G // 4
    if (W_eff.shape != (UH, G) or b_packed.shape != (G,)
            or h0.shape != (B, UH) or c0.shape != (B, UH)):
        raise ValueError("wavefront_fwd: W_eff, b_packed, h0 or c0 does not "
                         f"match xs_wave {tuple(xs_wave.shape)}")
    dtype, device = xs_wave.dtype, xs_wave.device
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    h_seq, h_fin, c_fin = new(K, B, UH), new(B, UH), new(B, UH)
    ptrs = [x.data_ptr() for x in tensors + (lvec, h_seq)]
    if with_residuals:
        gates_seq, c_seq = new(K, B, G), new(K, B, UH)
        ptrs += [gates_seq.data_ptr(), c_seq.data_ptr()]
        entry = f"wavefront_fwd_res_{_DTYPES[dtype]}"
    else:
        entry = f"wavefront_fwd_{_DTYPES[dtype]}"
    ptrs += [h_fin.data_ptr(), c_fin.data_ptr()]
    with torch.cuda.device(device):
        err = _kernel("wavefront_fwd.cu", entry, len(ptrs))(
            *ptrs, K, B, UH, UH // lvec.numel(), S,
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    if with_residuals:
        wavefront_fwd.residual_launches += 1
        return h_seq, h_fin, c_fin, gates_seq, c_seq
    wavefront_fwd.launches += 1
    return h_seq, h_fin, c_fin


wavefront_fwd.launches = 0
wavefront_fwd.residual_launches = 0


def wavefront_bwd(W_eff: torch.Tensor, gates_seq: torch.Tensor,
                  c_seq: torch.Tensor, c_prev_seq: torch.Tensor,
                  dY: torch.Tensor, dh0: torch.Tensor, dc0: torch.Tensor,
                  lvec: torch.Tensor, S: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse wavefront: (dgates_seq (K, B, 4UH), dh_fin, dc_fin (B, UH)).

    Arguments as in `wavefront_bwd_plain`; on CUDA the same contract as
    `wavefront_fwd`. The kernel reads W_eff transposed, (4UH, UH)
    contiguous, which this wrapper forms.
    """
    if _device_type("wavefront_bwd", gates_seq) == "cpu":
        return wavefront_bwd_plain(W_eff, gates_seq, c_seq, c_prev_seq, dY,
                                   dh0, dc0, lvec, S)
    tensors = (W_eff, gates_seq, c_seq, c_prev_seq, dY, dh0, dc0)
    _check("wavefront_bwd", tensors, lvec, gates_seq)
    K, B, G = gates_seq.shape
    UH = G // 4
    if (W_eff.shape != (UH, G) or dh0.shape != (B, UH) or dc0.shape != (B, UH)
            or any(x.shape != (K, B, UH) for x in (c_seq, c_prev_seq, dY))):
        raise ValueError("wavefront_bwd: W_eff, c_seq, c_prev_seq, dY, dh0 or "
                         f"dc0 does not match gates_seq {tuple(gates_seq.shape)}")
    dtype, device = gates_seq.dtype, gates_seq.device
    wt = W_eff.t().contiguous()
    dgates_seq = torch.empty((K, B, G), dtype=dtype, device=device)
    dh_fin = torch.empty((B, UH), dtype=dtype, device=device)
    dc_fin = torch.empty((B, UH), dtype=dtype, device=device)
    entry = f"wavefront_bwd_{_DTYPES[dtype]}"
    ptrs = [x.data_ptr() for x in (wt,) + tensors[1:] + (lvec, dgates_seq,
                                                        dh_fin, dc_fin)]
    with torch.cuda.device(device):
        err = _kernel("wavefront_bwd.cu", entry, len(ptrs))(
            *ptrs, K, B, UH, UH // lvec.numel(), S,
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wavefront_bwd.launches += 1
    return dgates_seq, dh_fin, dc_fin


wavefront_bwd.launches = 0


class WavefrontFunction(torch.autograd.Function):
    """The forward wavefront with the JAX package's hand-written backward.

    Differentiable inputs: W_eff, b_packed, xs_wave, h0, c0. The backward
    runs the reverse wavefront (`wavefront_bwd`) for dgates_seq and the
    cotangents of h0 and c0, then forms the weight gradients outside the
    recurrence (`blocks._wavefront_weight_grads`): dW_eff is one product of
    the shifted h_seq against dgates_seq over the (K*B) axis with fp32
    accumulation, db the fp32 sum of dgates over (K, B), and dxs_wave is
    dgates_seq itself. Unused outputs reach the backward as zeros.
    """

    @staticmethod
    def forward(ctx, W_eff, b_packed, xs_wave, h0, c0, lvec, S):
        h_seq, h_fin, c_fin, gates_seq, c_seq = wavefront_fwd(
            W_eff, b_packed, xs_wave, h0, c0, lvec, S, with_residuals=True)
        ctx.save_for_backward(W_eff, h0, c0, lvec, h_seq, gates_seq, c_seq)
        ctx.S = S
        return h_seq, h_fin, c_fin

    @staticmethod
    def backward(ctx, dY, dh_fin, dc_fin):
        W_eff, h0, c0, lvec, h_seq, gates_seq, c_seq = ctx.saved_tensors
        dtype = gates_seq.dtype
        K, B, G = gates_seq.shape
        UH = G // 4
        c_prev_seq = torch.cat([c0[None], c_seq[:-1]])
        dgates_seq, dh0, dc0 = wavefront_bwd(
            W_eff, gates_seq, c_seq, c_prev_seq,
            dY.to(dtype).contiguous(), dh_fin.to(dtype).contiguous(),
            dc_fin.to(dtype).contiguous(), lvec, ctx.S)
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        dW_eff = db = None
        if ctx.needs_input_grad[0]:
            h_prev = torch.cat([h0[None], h_seq[:-1]]).reshape(K * B, UH)
            dW_eff = (h_prev.to(acc).t() @ dgates_seq.reshape(K * B, G).to(acc)
                      ).to(dtype)
        if ctx.needs_input_grad[1]:
            db = dgates_seq.to(acc).sum((0, 1)).to(dtype)
        return dW_eff, db, dgates_seq, dh0, dc0, None, None


def wavefront_recurrence(W_eff: torch.Tensor, b_packed: torch.Tensor,
              xs_wave: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              lvec: torch.Tensor, S: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The differentiable forward wavefront: (h_seq, h_fin, c_fin).

    Without a gradient to record (inference mode, no_grad, or no input that
    requires one) this is the residual-free `wavefront_fwd`; otherwise
    `WavefrontFunction`, which stores the residuals for its backward.
    """
    tensors = (W_eff, b_packed, xs_wave, h0, c0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return WavefrontFunction.apply(W_eff, b_packed, xs_wave, h0, c0,
                                       lvec, S)
    return wavefront_fwd(W_eff, b_packed, xs_wave, h0, c0, lvec, S)
