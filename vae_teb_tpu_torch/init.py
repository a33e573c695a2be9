"""Seeded parameter initialization that mirrors the JAX package's flax
initializers, for runs without a flax checkpoint.

  Linear and Conv1d weights   xavier-uniform, biases zero
  InceptionTime convolutions  he-normal (truncated normal, variance
  (`SameConv1d`)              2 / fan_in, fan_in = in x k)
  self-attention kernels      lecun-normal (truncated normal, variance
  (query, key, value, out)    1 / fan_in over the contracted axes: C for
                              the projections, heads x head_dim for out),
                              biases zero (flax's attention defaults)
  LSTM w_ih_l, w_hh_l         orthogonal; bias_l zero with the forget
                              gate's block [H, 2H) at 1
  LayerNorm, BatchNorm        weight 1, bias 0; running mean 0, var 1

The draws come from an explicit CPU `torch.Generator`, so a seed gives the
same weights on every device. They are not flax's numbers: the two
frameworks' generators differ.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .models.blocks import LSTM, BatchNorm
from .models.inception_time import SameConv1d, _HeadsDense, _OutDense


def _xavier_uniform(shape, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def _truncated_normal(shape, variance: float,
                      generator: torch.Generator) -> torch.Tensor:
    """flax's variance_scaling(..., "truncated_normal"): a standard normal
    truncated to [-2, 2], scaled to the given variance."""
    std = math.sqrt(variance) / .87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0,
                                       2.0, generator=generator) * std


def _orthogonal(rows: int, cols: int, generator: torch.Generator) -> torch.Tensor:
    """A (rows, cols) matrix with orthonormal rows or columns, whichever is
    fewer (flax `orthogonal()` / torch `orthogonal_`)."""
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q if rows >= cols else q.T).to(torch.float32)


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize every parameter and BatchNorm statistic of `model` in
    place from `seed`; returns the model."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, SameConv1d):
            out_c, in_c, k = module.weight.shape
            module.weight.copy_(_truncated_normal(module.weight.shape,
                                                  2.0 / (in_c * k), g))
        elif isinstance(module, (_HeadsDense, _OutDense)):
            fan_in = (module.weight.shape[0] if isinstance(module, _HeadsDense)
                      else module.weight.shape[0] * module.weight.shape[1])
            module.weight.copy_(_truncated_normal(module.weight.shape,
                                                  1.0 / fan_in, g))
            module.bias.zero_()
        elif isinstance(module, nn.Linear):
            out_f, in_f = module.weight.shape
            module.weight.copy_(_xavier_uniform(module.weight.shape, in_f,
                                                out_f, g))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Conv1d):
            out_c, in_c, k = module.weight.shape
            module.weight.copy_(_xavier_uniform(module.weight.shape, in_c * k,
                                                out_c * k, g))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, BatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        elif isinstance(module, LSTM):
            H = module.hidden_size
            for name, p in module.named_parameters(recurse=False):
                if name.startswith("bias_"):
                    p.zero_()
                    p[H:2 * H] = 1.0
                else:
                    p.copy_(_orthogonal(*p.shape, g))
    return model
