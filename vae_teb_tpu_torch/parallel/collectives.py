"""The collectives of data- and tensor-parallel training, and the rows of
the noise a data-parallel rank draws.

Each collective is all_reduce, broadcast or all_gather, which NCCL and gloo
both take on CUDA tensors. The autograd functions:

  all_reduce_sum(x, group)     sum over the group; the backward sums the
                               gradient over it too (synced BatchNorm)
  copy_to_group(x, group)      identity; the backward sums the gradient
                               over the group (the input of a
                               column-parallel product)
  gather_columns(y, group, i, n)
                               every rank's block of the last axis, in
                               rank order; the backward takes block i of
                               the gradient. Every rank of a model group
                               computes the same loss on the same rows, so
                               the gradient after the gather is the same on
                               all of them and each keeps its own columns
                               (a reduce-scatter would sum n copies).

`noise_rows(index, count)` makes the noise draws of the models (`draw`,
used by `sample_z` and the classifier's dropout) draw the global batch's
noise, count times the local rows, and keep block `index` of it: every
rank of a data group runs the same seeded generator, so each draws what one
process over the global batch draws, and keeps its rows of it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, count):
        ctx.index, ctx.width = index, y.shape[-1]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(count)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.index * w:(ctx.index + 1) * w].contiguous(), None, \
            None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def gather_columns(y: torch.Tensor, group, index: int, count: int
                   ) -> torch.Tensor:
    return _GatherColumns.apply(y, group, index, count)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, count: int
                     ) -> None:
    """Average `tensors` in place over the group (count ranks): one flat
    all_reduce per dtype, then a division by count."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= count
        parts = torch.split(flat, [t.numel() for t in ts])
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(parts, ts)])


@torch.no_grad()
def gather_rows(x: torch.Tensor, group, count: int) -> torch.Tensor:
    """The whole array of which each rank of the group holds a block of
    rows (axis 0), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


_ROWS: contextvars.ContextVar = contextvars.ContextVar("noise_rows",
                                                        default=None)


@contextlib.contextmanager
def noise_rows(index: int, count: int):
    """Within the block, `draw` draws count times the local rows and keeps
    block `index` (a data-parallel rank's rows of the global batch)."""
    token = _ROWS.set((index, count))
    try:
        yield
    finally:
        _ROWS.reset(token)


def draw(fn: Callable[..., torch.Tensor], shape: Sequence[int], **kwargs
         ) -> torch.Tensor:
    """fn(shape, **kwargs) (torch.randn, torch.rand), whose axis 0 is the
    batch: under `noise_rows(i, n)` fn draws the global (n * B, ...) and the
    call returns rows [i B, (i + 1) B)."""
    rows = _ROWS.get()
    if rows is None:
        return fn(tuple(shape), **kwargs)
    i, n = rows
    b = shape[0]
    return fn((n * b,) + tuple(shape[1:]), **kwargs)[i * b:(i + 1) * b]


def local_rows(x: torch.Tensor, local_batch: int) -> torch.Tensor:
    """The rows of a caller's global array (e.g. eps) this rank keeps under
    `noise_rows`; x itself outside it."""
    rows = _ROWS.get()
    if rows is None:
        return x
    i, n = rows
    if x.shape[0] != n * local_batch:
        raise ValueError(f"expected the global batch of {n * local_batch} "
                         f"rows, got {x.shape[0]}")
    return x[i * local_batch:(i + 1) * local_batch]
