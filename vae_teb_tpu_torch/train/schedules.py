"""Beta (KLD weight) and learning-rate schedules, the optimizer, and
gradient accumulation.

Port of `vae_teb_tpu.train.schedules`. `make_optimizer` builds the JAX
package's optax chain as one `torch.optim.Optimizer`:

  clip_by_global_norm(grad_clip_norm) -> Adam (moments at rest in
  moment_dtype) -> + weight_decay * p -> * (-lr)

with optax's arithmetic, which differs from PyTorch's stock pieces:

- the clip rescales as (g / norm) * max_norm when norm >= max_norm, and
  leaves g untouched below; `torch.nn.utils.clip_grad_norm_` divides by
  norm + 1e-6 and always multiplies;
- Adam's moment arithmetic runs in the gradient's dtype and the moments are
  rounded to moment_dtype at rest (`scale_by_adam_with_dtype`); the bias
  corrections 1 - b**count are computed in fp32;
- weight decay is added to the Adam direction before the learning rate
  scales it (decoupled, as `optax.adamw`), and the step is p + (-lr * u).

The JAX package packs its small parameters into one flat vector for the
chain (`flat_param_fusion`); packing does not change the result, so this
port runs the same math over the parameter list with `torch._foreach_*`.

`MultiSteps` is `optax.MultiSteps`: gradients averaged over k micro-steps,
the wrapped optimizer stepped once per k on the average.

Under tensor parallelism (`sharded`, `model_group`) some parameters are a
model rank's rows of a larger weight. The clip then uses the norm of the
global arrays, as `optax.global_norm` does: the squared norms of the
sharded gradients sum over the model group and the replicated ones count
once. Their Adam moments are the shards' own, so they live sharded. Under
data parallelism the trainer hands the optimizer gradients already
averaged over the data group, on every micro-step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch


def beta_schedule(schedule: str = "linear", beta_start: float = 0.0,
                  beta_end: float = 1.0, anneal_epochs: int = 100,
                  cycle_len: int = 1000, const_val: float = 1.0
                  ) -> Callable[[int], float]:
    """Per-epoch KLD weight: "linear", "cyclic" or "constant"."""
    if schedule not in ("linear", "cyclic", "constant"):
        raise ValueError(f"unknown beta schedule: {schedule}")

    def fn(epoch: int) -> float:
        if schedule == "linear":
            progress = min(1.0, epoch / anneal_epochs)
            return beta_start + (beta_end - beta_start) * progress
        if schedule == "cyclic":
            progress = (epoch % cycle_len) / cycle_len
            return beta_start + (beta_end - beta_start) * progress
        return const_val
    return fn


def cosine_warm_restarts(base_lr: float, t0_steps: int,
                         eta_min_ratio: float = 0.01) -> Callable:
    """Cosine annealing with warm restarts (T_mult=1): identical cosine
    cycles of t0_steps optimizer steps, floored at eta_min_ratio * base_lr.
    Evaluated in fp32, as the JAX schedule is, on the step's device: the
    step is an integer (an int, or the optimizer's count tensor, which a
    CUDA graph of the step then reads when it replays) and the result a
    0-dim fp32 tensor."""
    t0_steps = max(int(t0_steps), 1)

    def c(v):   # a constant's fp32 value
        return float(np.float32(v))

    def fn(step) -> torch.Tensor:
        pos = torch.remainder(torch.as_tensor(step), t0_steps).float() \
            / c(t0_steps)
        cos = 0.5 * (1.0 + torch.cos(c(math.pi) * pos))
        return c(base_lr) * (c(eta_min_ratio) + c(1.0 - eta_min_ratio) * cos)
    return fn


def global_norm(grads: List[torch.Tensor],
                sharded: Optional[List[bool]] = None,
                model_group=None) -> torch.Tensor:
    """The L2 norm of all gradients together (`optax.global_norm`), a 0-dim
    tensor on their device. With `sharded` (a flag per gradient: a model
    rank's block of a larger array) the norm is the global arrays': the
    sharded blocks' squared norms are summed over `model_group`."""
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    import torch.distributed as dist
    norms = torch.stack(torch._foreach_norm(grads))
    mask = torch.as_tensor(sharded, device=norms.device)
    sq = norms * norms
    part = torch.where(mask, sq, 0.0).sum()
    dist.all_reduce(part, group=model_group)
    return torch.sqrt(torch.where(mask, 0.0, sq).sum() + part)


def _params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


class ClippedAdamW(torch.optim.Optimizer):
    """Global-norm clip, Adam with moments stored in `moment_dtype`,
    decoupled weight decay and the learning rate, as the JAX package's
    `make_optimizer` chain (see the module docstring for the arithmetic).

    `lr` is a float or a schedule step -> lr, evaluated at the number of
    updates taken before this one (optax's count). The count lives on the
    parameters' device as an int32 tensor (`count`), as optax's does, and
    the bias corrections 1 - b**count and a scheduled lr (given the count
    tensor) are computed there in fp32: a step reads no host value that
    changes between steps, so a CUDA graph of it replays exactly.
    `state_dict()` keeps the count as a Python int. `step()` reads `p.grad`
    without changing it, updates the parameters and the moments in place,
    and returns the global gradient norm before clipping as a 0-dim tensor
    on the parameters' device (no host synchronisation). The first step
    creates the moments. `sharded`: the parameters that are a model rank's
    block of a larger weight, whose squared norms sum over `model_group`
    (see the module docstring).
    """

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable[[int], float]] = 1e-4,
                 grad_clip_norm: float = 0.5, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: Optional[torch.dtype] = None,
                 sharded: Iterable[torch.Tensor] = (), model_group=None):
        super().__init__(params, dict(lr=lr, grad_clip_norm=grad_clip_norm,
                                      weight_decay=weight_decay, b1=b1, b2=b2,
                                      eps=eps, moment_dtype=moment_dtype))
        if len(self.param_groups) != 1:
            raise ValueError("ClippedAdamW clips over one global norm: pass "
                             "one parameter group")
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.param_groups[0]["params"][0].device)
        self.sharded = {id(p) for p in sharded}
        self.model_group = model_group

    def grad_norm(self, params: List[torch.Tensor],
                  grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of `grads`, the gradients of `params`."""
        return global_norm(grads, [id(p) in self.sharded for p in params],
                           self.model_group)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("ClippedAdamW.step takes no closure")
        group = self.param_groups[0]
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            raise RuntimeError("ClippedAdamW.step: no parameter has a gradient")
        grads = [p.grad for p in params]
        b1, b2 = group["b1"], group["b2"]
        moment_dtype = group["moment_dtype"]
        for p in params:
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p, dtype=moment_dtype or p.dtype)
                st["nu"] = torch.zeros_like(p, dtype=moment_dtype or p.dtype)

        # optax.clip_by_global_norm: below max_norm the gradient passes
        # unchanged, above it becomes (g / norm) * max_norm; one divisor and
        # one factor per branch keep both exact without a host round trip
        norm = self.grad_norm(params, grads)
        max_norm = group["grad_clip_norm"]
        below = norm < max_norm
        g = torch._foreach_div(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(g, torch.where(below, 1.0, max_norm))

        # Adam moments: arithmetic in the gradient's dtype, stored at rest
        # in moment_dtype
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        mu = [m.to(x.dtype) for m, x in zip(mus, g)]
        nu = [v.to(x.dtype) for v, x in zip(nus, g)]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        self.count += 1
        count = self.count.float()
        bc1 = 1 - torch.pow(b1, count)
        bc2 = 1 - torch.pow(b2, count)
        # (mu / bc1) / (sqrt(nu / bc2) + eps)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        if any(m is not x for m, x in zip(mus, mu)):   # round to moment_dtype
            torch._foreach_copy_(mus, mu)
            torch._foreach_copy_(nus, nu)

        # decoupled weight decay, then the learning rate: p + (-lr * u)
        torch._foreach_add_(upd, torch._foreach_mul(params,
                                                    group["weight_decay"]))
        lr = group["lr"]
        lr = -lr(self.count - 1) if callable(lr) else -lr
        torch._foreach_mul_(upd, lr)
        torch._foreach_add_(params, upd)
        return norm

    def state_dict(self) -> Dict:
        """The update count and both moments per parameter, in the
        parameters' order and the moments' own dtype (None for a parameter
        not yet stepped). The schedule and hyperparameters are not state:
        they come from the constructor."""
        params = _params(self)
        return {"count": int(self.count),
                "mu": [self.state[p]["mu"] if p in self.state else None
                       for p in params],
                "nu": [self.state[p]["nu"] if p in self.state else None
                       for p in params]}

    def load_state_dict(self, state: Dict) -> None:
        params = _params(self)
        if len(state["mu"]) != len(params):
            raise ValueError(f"optimizer state for {len(state['mu'])} "
                             f"parameters, this optimizer has {len(params)}")
        self.count.fill_(int(state["count"]))
        self.state.clear()
        for p, mu, nu in zip(params, state["mu"], state["nu"]):
            if mu is not None:
                self.state[p] = {"mu": mu.to(p.device, copy=True),
                                 "nu": nu.to(p.device, copy=True)}


class MultiSteps:
    """`optax.MultiSteps(inner, every_k_schedule=k)`: gradient accumulation.

    Each `step()` folds the parameters' current gradients into a running
    mean, acc += (g - acc) / (micro_step + 1), as optax does. On the k-th
    micro-step it hands the mean to the wrapped optimizer as `p.grad` and
    steps it once, then resets the mean; on the others the parameters, the
    wrapped optimizer's state and its count stay as they are. `step()`
    returns the global norm of the micro-step's own gradient, the
    `grad_norm` the JAX package reports per micro-step.

    The micro-step is a host value and each one takes its own branch (a
    CUDA graph of the train step is captured per micro-step, and the
    trainer calls `advance()` after each replay). The running
    mean lives in buffers made at the first step and zeroed at each
    micro-step 0, so every graph reads and writes the same memory.
    """

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = _params(self.inner)
        if any(p.grad is None for p in params):
            raise RuntimeError("MultiSteps.step: every parameter needs a "
                               "gradient")
        grads = [p.grad for p in params]
        norm = (self.inner.grad_norm(params, grads)
                if hasattr(self.inner, "grad_norm") else global_norm(grads))
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        elif self.mini_step == 0:
            torch._foreach_zero_(self.acc)
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        self.mini_step += 1
        if self.mini_step == self.every_k:
            for p, a in zip(params, self.acc):
                p.grad = a
            self.inner.step()
            self.mini_step = 0
        return norm

    def advance(self) -> None:
        """Move on one micro-step as `step()` does, on the host alone: after
        a CUDA graph of a train step replays, which runs `step()`'s device
        work and none of its Python."""
        self.mini_step = (self.mini_step + 1) % self.every_k

    def state_dict(self) -> Dict:
        """The micro-step, the running mean (None at micro-step 0, when
        none is held) and the wrapped optimizer's state."""
        return {"mini_step": self.mini_step,
                "acc": self.acc if self.mini_step else None,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        params = _params(self.inner)
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.acc = (None if state["acc"] is None else
                    [a.to(p.device, copy=True)
                     for a, p in zip(state["acc"], params)])


def make_optimizer(params: Iterable[torch.Tensor],
                   lr: Union[float, Callable[[int], float]],
                   grad_clip_norm: float = 0.5, weight_decay: float = 1e-4,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   moment_dtype: Optional[torch.dtype] = None,
                   sharded: Iterable[torch.Tensor] = (),
                   model_group=None) -> ClippedAdamW:
    """The AdamW chain with global-norm clipping over `params`.
    moment_dtype=torch.bfloat16 stores both Adam moments at rest in bf16;
    None keeps them in the parameters' dtype. `sharded` / `model_group`:
    tensor-parallel blocks (see `ClippedAdamW`)."""
    return ClippedAdamW(params, lr, grad_clip_norm, weight_decay, b1, b2, eps,
                        moment_dtype, sharded, model_group)
