"""The arithmetic the reference computes in.

`Precision()` is the reference itself: float64, products exact to float64.
The controls lower it to the precision just below the one a configuration
states, as an implementation of the same model in that precision would
compute: float32 arithmetic, and the operands of every product (matrix
products, convolutions, the LSTMs' products) rounded first:

  tf32  to TF32's 10 explicit mantissa bits, round to nearest even (the
        tensor cores' TF32 route for float32 storage with TF32 on);
  fp8   to float8 e4m3 with one scale per operand tensor (amax / 448), the
        usual per-tensor scaling of an fp8 product; gradients to e5m2.

Accumulation stays float32 in both, as on the tensor cores. In training
the backward's products round their operands too (the output gradient,
the weights and the saved input), as a training step on that route would.
Under fp8, the control of a bf16 configuration, what the bf16 policy
stores in bf16 is stored in fp8 as well (`store`): every layer's output,
the activations and the LSTMs' states at each step, and the gradient
that flows back through each in e5m2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to 10 mantissa bits, nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x.float())
    return torch.where(finite, rounded.view(torch.float32), x.float())


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 values through float8 e4m3 with a per-tensor scale."""
    return _scaled(x, torch.float8_e4m3fn, 448.0)


def round_e5m2(x: torch.Tensor) -> torch.Tensor:
    """float32 gradients through float8 e5m2 with a per-tensor scale."""
    return _scaled(x, torch.float8_e5m2, 57344.0)


# (forward operands and stores, gradients) of each lowered precision
ROUNDINGS = {"fp32": (None, None), "tf32": (round_tf32, round_tf32),
             "fp8": (round_fp8, round_e5m2)}


class _RoundedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd, rnd_grad):
        ctx.rnd_grad = rnd_grad
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd_grad(g)
        return rg @ rb.transpose(-1, -2), \
            (ra.reshape(-1, ra.shape[-1]).t() @ rg.reshape(-1, g.shape[-1])
             ).reshape(rb.shape), None, None


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, rnd, rnd_grad):
        ctx.rnd_grad = rnd_grad
        rx, rw = rnd(x), rnd(w)
        ctx.save_for_backward(rx, rw)
        return F.conv1d(rx, rw)

    @staticmethod
    def backward(ctx, g):
        rx, rw = ctx.saved_tensors
        rg = ctx.rnd_grad(g)
        return (torch.nn.grad.conv1d_input(rx.shape, rw, rg),
                torch.nn.grad.conv1d_weight(rx, rw.shape, rg), None, None)


class _Store(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rnd, rnd_grad):
        ctx.rnd_grad = rnd_grad
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd_grad(g), None, None


class Precision:
    """`name` None: float64 and exact products; "fp32": float32; "tf32" or
    "fp8": float32 with each product's operands rounded as the module
    docstring says."""

    def __init__(self, name: Optional[str] = None):
        if name is not None and name not in ROUNDINGS:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.real = torch.float64 if name is None else torch.float32
        self._round, self._round_grad = ROUNDINGS.get(name, (None, None))

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """x as the policy stores an activation: rounded under fp8."""
        if self.name != "fp8":
            return x
        return _Store.apply(x, self._round, self._round_grad)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., k) @ b (k, n), b a matrix."""
        a, b = a.to(self.real), b.to(self.real)
        if self._round is None:
            return a @ b
        return _RoundedMM.apply(a, b, self._round, self._round_grad)

    def conv1d(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.real), w.to(self.real)
        if self._round is None:
            return F.conv1d(x, w)
        return _RoundedConv.apply(x, w, self._round, self._round_grad)
