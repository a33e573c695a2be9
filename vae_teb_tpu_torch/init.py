"""Seeded parameter initialization that mirrors the JAX package's flax
initializers, for runs without a flax checkpoint.

  Linear and Conv1d weights   xavier-uniform, biases zero
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


def _xavier_uniform(shape, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


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
        if isinstance(module, nn.Linear):
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
