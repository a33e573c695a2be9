"""Linear 2x upsampling of (B, L, C) along L, and its gradient: a
hand-written CUDA kernel pair (`upsample.cu`) beside its plain PyTorch
version.

`upsample_linear2x_fwd` and `upsample_linear2x_bwd` pick by the device of
their input: a CPU tensor takes the plain version
(`upsample_linear2x_fwd_plain`: F.interpolate in float32 and float64, the
blends written out below float32; `upsample_linear2x_bwd_plain`: a gather
of the four output gradients that touch each input), a CUDA tensor
launches the kernel (entry points `upsample_linear2x_{fwd,bwd}_{f32,bf16}`,
float32 or bfloat16 storage), anything else raises. The kernel computes
what the plain version computes, bit for bit in the forward (see
`upsample.cu`). Each launch adds one to its wrapper's `launches` and to
its entry point's count in `entry_launches` (`launches.launch_counts`).

Layout: the output keeps the input's physical layout. An input whose
transpose is contiguous, physically (B, C, L) as the decoder's conv
outputs are, gives an output physically (B, C, 2L), so the caller's
transpose back to (B, C, 2L) is a view; any other input is made a
contiguous (B, L, C) and gives a contiguous (B, 2L, C). The gradient does
the same from the output gradient's layout.

`linear_upsample` is the differentiable function the model calls: the
operator `torch.ops.vae_teb_tpu_torch.upsample_linear2x`
(`upsample_linear2x_op`) when no gradient is wanted, which `torch.export`
keeps as one node and a program dispatches by device when it runs;
otherwise, on CUDA, `LinearUpsampleFunction`, whose backward is the
gather kernel (on the CPU, autograd through the plain forward). Neither
records anything a CUDA-graph replay would freeze: a launch reads only
shapes and pointers.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build
from .launches import counted

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _channels_first(x: torch.Tensor) -> bool:
    """Whether (B, L, C) x lies physically as (B, C, L), contiguous."""
    return x.transpose(1, 2).is_contiguous()


def _in_layout(y: torch.Tensor, channels_first: bool) -> torch.Tensor:
    """(B, L', C) y in the physical layout `channels_first` names."""
    if channels_first:
        return y.transpose(1, 2).contiguous().transpose(1, 2)
    return y.contiguous()


def upsample_linear2x_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) -> (B, 2L, C), half-pixel centres (the JAX package's
    `jax.image.resize(method="linear")`): output 2i blends x[i-1] and x[i]
    by 1/4 and 3/4, output 2i+1 x[i] and x[i+1] by 3/4 and 1/4, the edges
    clamped. float32 and float64 take F.interpolate; below float32 the
    blends are written out in float32 and rounded once, which is bit for
    bit what F.interpolate computes there. In x's physical layout."""
    channels_first = _channels_first(x)
    if x.dtype in (torch.float32, torch.float64):
        y = F.interpolate(x.transpose(1, 2), size=2 * x.shape[1],
                          mode="linear", align_corners=False).transpose(1, 2)
    else:
        xf = x.float()
        prev = torch.cat([xf[:, :1], xf[:, :-1]], dim=1)
        nxt = torch.cat([xf[:, 1:], xf[:, -1:]], dim=1)
        y = torch.stack([0.25 * prev + 0.75 * xf, 0.75 * xf + 0.25 * nxt],
                        dim=2)
        y = y.reshape(x.shape[0], 2 * x.shape[1], x.shape[2]).to(x.dtype)
    return _in_layout(y, channels_first)


def upsample_linear2x_bwd_plain(dy: torch.Tensor) -> torch.Tensor:
    """The gradient of `upsample_linear2x_fwd_plain`: (B, 2L, C) -> (B, L,
    C), dx[i] = 1/4 (dy[2i-1] + dy[2i+2]) + 3/4 (dy[2i] + dy[2i+1]), dy's
    index clamped to [0, 2L-1] (dx[0] takes dy[0] whole, dx[L-1]
    dy[2L-1]); summed in float32 (float64 for float64) and rounded once.
    In dy's physical layout."""
    channels_first = _channels_first(dy)
    acc = dy.double() if dy.dtype == torch.float64 else dy.float()
    ev, od = acc[:, 0::2], acc[:, 1::2]
    prev_odd = torch.cat([ev[:, :1], od[:, :-1]], dim=1)
    next_even = torch.cat([ev[:, 1:], od[:, -1:]], dim=1)
    dx = 0.25 * (prev_odd + next_even) + 0.75 * (ev + od)
    return _in_layout(dx.to(dy.dtype), channels_first)


def _device_type(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no implementation for {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name} takes (B, L, C), got {tuple(x.shape)}")
    return x.device.type


def _launch(kind: str, src: torch.Tensor) -> Tuple[torch.Tensor, str]:
    """Launch entry `upsample_linear2x_{kind}_<dtype>` ("fwd": src (B, L,
    C) -> (B, 2L, C); "bwd": src (B, 2L, C) -> (B, L, C)) into a new
    output in src's physical layout; raises on a CUDA error. Returns
    (output, entry)."""
    if src.dtype not in _DTYPES:
        raise TypeError(f"upsample_linear2x_{kind} takes float32 or "
                        f"bfloat16 on CUDA, got {src.dtype}")
    B, n, C = src.shape
    L = n if kind == "fwd" else n // 2
    out_len = 2 * L if kind == "fwd" else L
    if _channels_first(src):
        out = torch.empty((B, C, out_len), dtype=src.dtype,
                          device=src.device).transpose(1, 2)
        outer, inner = B * C, 1
    else:
        src = src.contiguous()
        out = torch.empty((B, out_len, C), dtype=src.dtype, device=src.device)
        outer, inner = B, C
    entry = f"upsample_linear2x_{kind}_{_DTYPES[src.dtype]}"
    vec = int(inner == 1 and L % 4 == 0 and src.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    fn = getattr(build.load("upsample.cu"), entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), out.data_ptr(), outer, L, inner, vec,
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return out, entry


@counted("launches")
def upsample_linear2x_fwd(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) -> (B, 2L, C) in x's physical layout: the plain version on
    the CPU, the kernel on CUDA (float32 or bfloat16; anything else
    raises). Records no autograd graph (see `linear_upsample`)."""
    if _device_type("upsample_linear2x_fwd", x) == "cpu":
        return upsample_linear2x_fwd_plain(x)
    if x.shape[1] < 1:
        raise ValueError("upsample_linear2x_fwd: empty sequence")
    y, entry = _launch("fwd", x)
    upsample_linear2x_fwd.launches += 1
    upsample_linear2x_fwd.entry_launches[entry] += 1
    return y


@counted("launches")
def upsample_linear2x_bwd(dy: torch.Tensor) -> torch.Tensor:
    """The gradient, (B, 2L, C) -> (B, L, C) in dy's physical layout: the
    plain gather on the CPU, the kernel on CUDA."""
    if _device_type("upsample_linear2x_bwd", dy) == "cpu":
        return upsample_linear2x_bwd_plain(dy)
    if dy.shape[1] < 2 or dy.shape[1] % 2:
        raise ValueError(f"upsample_linear2x_bwd: odd or empty length "
                         f"{dy.shape[1]}")
    dx, entry = _launch("bwd", dy)
    upsample_linear2x_bwd.launches += 1
    upsample_linear2x_bwd.entry_launches[entry] += 1
    return dx


@torch.library.custom_op("vae_teb_tpu_torch::upsample_linear2x",
                         mutates_args=())
def upsample_linear2x_op(x: torch.Tensor) -> torch.Tensor:
    """`upsample_linear2x_fwd` as one operator,
    `vae_teb_tpu_torch::upsample_linear2x`: `torch.export` keeps it as one
    node (its fake implementation gives the output's shape and strides from
    the input's, a symbolic batch included), and a program that holds it
    picks the implementation by device when it runs."""
    return upsample_linear2x_fwd(x)


@upsample_linear2x_op.register_fake
def _upsample_linear2x_fake(x):
    B, L, C = x.shape
    if _channels_first(x):
        return x.new_empty((B, C, 2 * L)).transpose(1, 2)
    return x.new_empty((B, 2 * L, C))


class LinearUpsampleFunction(torch.autograd.Function):
    """`upsample_linear2x_fwd` with the gather `upsample_linear2x_bwd` as
    its backward."""

    @staticmethod
    def forward(ctx, x):
        return upsample_linear2x_fwd(x)

    @staticmethod
    def backward(ctx, dy):
        return upsample_linear2x_bwd(dy)


def linear_upsample(x: torch.Tensor) -> torch.Tensor:
    """Linear 2x upsampling of (B, S, C) along S with half-pixel centres,
    the JAX package's `jax.image.resize(method="linear")`, differentiable:
    the operator `upsample_linear2x_op` when no gradient is recorded;
    otherwise on CUDA `LinearUpsampleFunction`, and on the CPU the plain
    forward, differentiated through its own operations (F.interpolate's
    backward in float32). The CPU's training trajectories are held to the
    JAX package's, and those comparisons turn on the gradient's rounding
    (an Adam step of a gradient within rounding of 0 goes either way), so
    the CPU keeps the rounding they were measured with. The output keeps
    x's physical layout (the decoder's `models.blocks.ReflectConvBlock`
    hands over the (B, S, C) view of a (B, C, S) conv output)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return upsample_linear2x_op(x)
    if _device_type("linear_upsample", x) == "cpu":
        return upsample_linear2x_fwd_plain(x)
    return LinearUpsampleFunction.apply(x)
