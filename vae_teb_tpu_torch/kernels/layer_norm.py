"""LayerNorm over the last axis, and its gradient: a hand-written CUDA
kernel pair (`layer_norm.cu`) beside its plain PyTorch version.

`layer_norm_fwd` and `layer_norm_bwd` pick by the device of their input: a
CPU tensor takes the plain version (`layer_norm_fwd_plain`: F.layer_norm,
in float32 or float64, with the row statistics; `layer_norm_bwd_plain`: the
gradient written out), a CUDA tensor launches the kernel (entry points
`layer_norm_fwd_f32` and `layer_norm_bwd_f32`, float32 only), anything else
raises. Each launch adds one to its wrapper's `launches` and to its entry
point's count in `entry_launches` (`launches.launch_counts`); an entry call
of the backward runs two kernels, the rows and the column sums.

`layer_norm_rows` is the differentiable function `models.blocks.LayerNorm`
calls on CUDA: `LayerNormFunction`, whose backward is the backward kernel,
when a gradient is recorded; otherwise the forward entry alone, without
the row statistics. Neither records anything a CUDA-graph replay would
freeze: a launch reads only shapes and pointers. While tracing the module
calls the operator `torch.ops.vae_teb_tpu_torch.layer_norm`
(`layer_norm_op`) instead, so an exported program launches the same
kernel as the live model and gives its bits.

Host time matters on the serving path, which calls it 115 times a
SeqVaeTeb forward: an entry point takes one argument, its arguments packed
as a C struct, and its argument type is bound once, when the library
loads; the common case is checked first; the launch goes to the current
stream's raw handle and takes a device context only for a tensor off the
current device; a call allocates its outputs and nothing else.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build
from .launches import counted

# Each entry point takes one pointer to its arguments packed as a C struct
# (`layer_norm.cu`'s LayerNormFwdArgs, LayerNormBwdArgs; natural alignment,
# null pointers as 0): ctypes converts one argument in place of ten, a few
# us of host time a call on the serving path.
_PACK = {   # x, gamma, beta, y, mean, rstd, M, W, eps, stream
    "layer_norm_fwd_f32": struct.Struct("@6PqifP").pack,
    # x, dy, mean, rstd, gamma, dx, partial, dgamma, dbeta, M, W,
    # max_blocks, stream
    "layer_norm_bwd_f32": struct.Struct("@9PqiiP").pack}
_entries: Dict[str, Callable] = {}


def _entry(name: str):
    """The entry point, its argument type bound when first loaded."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.load("layer_norm.cu"), name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _launch(name: str, index: int, *args) -> None:
    """Call entry `name` with args (all but the stream, pointers as ints)
    and the current stream of CUDA device `index`; raises on a CUDA
    error."""
    fn, pack = _entry(name), _PACK[name]
    if index == torch._C._cuda_getDevice():
        err = fn(pack(*args, torch._C._cuda_getCurrentRawStream(index)))
    else:
        with torch.cuda.device(index):
            err = fn(pack(*args, torch._C._cuda_getCurrentRawStream(index)))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _card_index(name: str, x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> Optional[int]:
    """x's CUDA device index where the kernel takes x with weight and bias
    (None, or a tensor like weight), None where the plain version does (x
    on the CPU). Raises on anything else: ValueError on a device other
    than the CPU and CUDA, a parameter whose shape is not (x's width,) or
    which lies on another device than x; TypeError on CUDA storage other
    than float32. What is taken is decided by the first two tests alone,
    the common case first in few host operations (the serving path calls
    this 115 times a forward); the rest only names the fault."""
    width, index = x.shape[-1] if x.dim() else -1, x.get_device()
    f32 = torch.float32
    if x.is_cuda:
        if x.dtype is f32 and weight.dtype is f32 and \
                weight.shape == (width,) and weight.get_device() == index \
                and (bias is None or (bias.dtype is f32 and bias.shape ==
                                      (width,) and bias.get_device() == index)):
            return index
    elif x.device.type == "cpu" and weight.shape == (width,) and \
            weight.device.type == "cpu" and (bias is None or (
                bias.shape == (width,) and bias.device.type == "cpu")):
        return None
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no implementation for {x.device}")
    for t in (weight, bias):
        if t is None:
            continue
        if t.shape != (width,):
            raise ValueError(f"{name}: a parameter of shape "
                             f"{tuple(t.shape)} for rows of width {width}")
        if t.device != x.device:
            raise ValueError(f"{name}: a parameter on {t.device} for x on "
                             f"{x.device}")
    raise TypeError(f"{name} takes float32 on CUDA, got {x.dtype} rows and "
                    f"{weight.dtype} parameters")


def layer_norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): y = F.layer_norm over the last axis in x's dtype
    (float32 or float64), and each row's mean and 1 / sqrt(var + eps) (the
    biased variance of the centered row), shaped x.shape[:-1]."""
    y = F.layer_norm(x, x.shape[-1:], weight, bias, eps)
    mean = x.mean(-1)
    var = (x - mean.unsqueeze(-1)).square().mean(-1)
    return y, mean, torch.rsqrt(var + eps)


def layer_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         weight: torch.Tensor, need_dx: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                    torch.Tensor]:
    """The gradient of `layer_norm_fwd_plain` from the output gradient dy
    and the forward's row statistics: (dx, or None without need_dx,
    dgamma, dbeta). With xh = (x - mean) * rstd and g = dy * weight, dx =
    rstd * (g - mean(g) - xh * mean(g * xh)) along each row; dgamma and
    dbeta sum dy * xh and dy over the rows."""
    xh = (x - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)
    dx = None
    if need_dx:
        g = dy * weight
        dx = rstd.unsqueeze(-1) * (g - g.mean(-1, keepdim=True)
                                   - xh * (g * xh).mean(-1, keepdim=True))
    width = x.shape[-1]
    return (dx, (dy * xh).reshape(-1, width).sum(0),
            dy.reshape(-1, width).sum(0))


@counted("launches")
def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, stats: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """(y, mean, rstd) of LayerNorm over x's last axis: the plain version
    on the CPU, the kernel on CUDA (float32; anything else raises).
    Without `stats` no row statistics are computed (the kernel writes
    none) and mean and rstd are None. Records no autograd graph (see
    `layer_norm_rows`)."""
    index = _card_index("layer_norm_fwd", x, weight, bias)
    if index is None:
        if not stats:
            return F.layer_norm(x, x.shape[-1:], weight, bias, eps), None, \
                None
        return layer_norm_fwd_plain(x, weight, bias, eps)
    x = x.contiguous()
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    width = x.shape[-1]
    rows = x.numel() // width if width else 0
    if rows:
        _launch("layer_norm_fwd_f32", index, x.data_ptr(),
                weight.contiguous().data_ptr(), bias.contiguous().data_ptr(),
                y.data_ptr(), 0 if mean is None else mean.data_ptr(),
                0 if rstd is None else rstd.data_ptr(), rows, width, eps)
        layer_norm_fwd.launches += 1
        layer_norm_fwd.entry_launches["layer_norm_fwd_f32"] += 1
    return y, mean, rstd


@counted("launches")
def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor,
                   need_dx: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                              torch.Tensor]:
    """The gradient, (dx or None, dgamma, dbeta), from x, the output
    gradient dy, the forward's row statistics and the scale: the plain
    version on the CPU, the kernel on CUDA. Without need_dx the kernel
    writes no dx. The column sums are deterministic: no atomics."""
    index = _card_index("layer_norm_bwd", x, weight)
    if index is None:
        return layer_norm_bwd_plain(x, dy, mean, rstd, weight, need_dx)
    if dy.shape != x.shape or mean.shape != x.shape[:-1] or \
            rstd.shape != mean.shape or \
            not all(t.get_device() == index for t in (dy, mean, rstd)):
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)}, mean "
                         f"{tuple(mean.shape)}, rstd {tuple(rstd.shape)} on "
                         f"{dy.device}, {mean.device}, {rstd.device} for x "
                         f"{tuple(x.shape)} on {x.device}")
    if not dy.dtype is mean.dtype is rstd.dtype is torch.float32:
        raise TypeError(f"layer_norm_bwd takes float32 on CUDA, got dy "
                        f"{dy.dtype}, mean {mean.dtype}, rstd {rstd.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    width = x.shape[-1]
    rows = x.numel() // width if width else 0
    dx = torch.empty_like(x) if need_dx else None
    dgamma = torch.empty(width, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    if not rows:
        return dx, dgamma.zero_(), dbeta.zero_()
    # the row kernel's blocks: at most 4 an SM, each a row of partial sums
    blocks = min(rows, 4 * torch.cuda.get_device_properties(
        index).multi_processor_count)
    partial = torch.empty(2 * blocks * width, dtype=torch.float32,
                          device=x.device)
    _launch("layer_norm_bwd_f32", index, x.data_ptr(), dy.data_ptr(),
            mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(),
            weight.contiguous().data_ptr(),
            0 if dx is None else dx.data_ptr(), partial.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), rows, width, blocks)
    layer_norm_bwd.launches += 1
    layer_norm_bwd.entry_launches["layer_norm_bwd_f32"] += 1
    return dx, dgamma, dbeta


@torch.library.custom_op("vae_teb_tpu_torch::layer_norm", mutates_args=())
def layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """`layer_norm_fwd` without row statistics as one operator,
    `vae_teb_tpu_torch::layer_norm`, which `models.blocks.LayerNorm` calls
    while tracing: `torch.export` keeps it as one node (its fake
    implementation gives a contiguous output of x's shape), and a program
    that holds it runs the kernel on the card and F.layer_norm on the CPU,
    as the live model does. It has no gradient."""
    return layer_norm_fwd(x, weight, bias, eps, False)[0]


@layer_norm_op.register_fake
def _layer_norm_fake(x, weight, bias, eps):
    return x.new_empty(x.shape)


class LayerNormFunction(torch.autograd.Function):
    """`layer_norm_fwd` with `layer_norm_bwd` as its backward; x's gradient
    is computed only where it is asked for."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dgamma, dbeta = layer_norm_bwd(x, dy, mean, rstd, weight,
                                           need_dx=need[0])
        return dx, dgamma if need[1] else None, dbeta if need[2] else None, \
            None


def layer_norm_rows(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over x's last axis, differentiable: `LayerNormFunction`
    when a gradient is recorded for any input, else `layer_norm_fwd`
    without row statistics."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps, False)[0]
