"""The training step of SeqVaeTeb: forward, ELBO, backward, clipped AdamW.

Port of the step of `vae_teb_tpu.train.trainer.Trainer` (`train_step`,
`eval_step`). PyTorch keeps the training state where the JAX package
threads a `TrainState` through a jitted function: the parameters and
BatchNorm statistics live in the module, the Adam moments and step count in
the optimizer, and the sampling noise comes from a `torch.Generator`, all
on one explicit device. Each step updates them in place.

Not ported yet (ROADMAP Queue 1): `fit` and its loop (checkpoints, early
stopping, prefetch, gradient accumulation, steps_per_execution), in-step
normalization of raw fields (`_prep`), the bf16 compute policy, and data
parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from ..device import resolve_device
from ..models.vae_teb import SeqVaeTeb, compute_loss
from .schedules import beta_schedule, cosine_warm_restarts, make_optimizer

FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")   # y_st, y_ph, x_ph, y_raw


@dataclass
class TrainerConfig:
    """The JAX `TrainerConfig` fields that the step uses (same defaults)."""
    lr: float = 1e-4
    grad_clip_norm: float = 0.5
    weight_decay: float = 1e-4
    kld_beta: float = 1e-5           # reference config.yaml kld_beta
    beta_schedule: str = "constant"
    beta_start: float = 0.0
    beta_end: float = 1.0
    beta_anneal_epochs: int = 100
    beta_cycle_len: int = 1000
    lr_t0_steps: int = 0             # 0 => constant lr
    seed: int = 42
    # compute precision: "fp32" only; params are always fp32
    precision: str = "fp32"
    # Adam moment storage: "fp32" or "bf16"
    moment_dtype: str = "fp32"

    def moment_torch_dtype(self) -> Optional[torch.dtype]:
        if self.moment_dtype == "bf16":
            return torch.bfloat16
        if self.moment_dtype in ("fp32", "float32"):
            return None
        raise ValueError(f"unknown moment_dtype: {self.moment_dtype!r}")


class Trainer:
    """Train and eval steps for a SeqVaeTeb on one device: the CUDA card
    unless `device` names another (`device="cpu"`); the model moves there.

    `train_step` and `eval_step` take a batch dict with the dataset's
    fields: fhr_st (B, S, 43), fhr_ph (B, S, 44), fhr_up_ph (B, S, 130) and
    the raw target fhr (B, 16 S), as arrays or tensors; they are moved to
    the trainer's device.
    """

    def __init__(self, model: SeqVaeTeb, config: TrainerConfig = TrainerConfig(),
                 device=None):
        if config.precision == "bf16":
            raise NotImplementedError(
                "precision='bf16' (the bf16 compute policy, SeqVaeTeb(dtype="
                "bf16)) is not ported yet: ROADMAP Queue 1, item 2")
        if config.precision not in ("fp32", "float32"):
            raise ValueError(f"unknown precision: {config.precision!r}")
        moment_dtype = config.moment_torch_dtype()   # raises if unknown
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        lr = (cosine_warm_restarts(config.lr, config.lr_t0_steps)
              if config.lr_t0_steps > 0 else config.lr)
        self.optimizer = make_optimizer(
            self.model.parameters(), lr, config.grad_clip_norm,
            config.weight_decay, moment_dtype=moment_dtype)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        # per-epoch KLD weight, as the JAX fit loop reads it
        self.beta_fn = beta_schedule(config.beta_schedule, config.beta_start,
                                     config.beta_end, config.beta_anneal_epochs,
                                     config.beta_cycle_len, config.kld_beta)

    def _batch(self, batch: Mapping):
        return tuple(torch.as_tensor(batch[k], dtype=torch.float32,
                                     device=self.device) for k in FIELDS)

    def train_step(self, batch: Mapping, beta: float,
                   eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch`, in place: the module's parameters
        and BatchNorm running statistics, the optimizer's moments and count,
        and the generator's state all advance.

        The forward runs in training mode (batch statistics) with z sampled
        from `self.generator`, or from the caller's standard-normal `eps`
        (B, S, latent) when given. Returns 0-dim device tensors: the four
        losses, total_loss, and grad_norm, the global gradient norm before
        clipping.
        """
        y_st, y_ph, x_ph, y_raw = self._batch(batch)
        model = self.model.train()
        out = model(y_st, y_ph, x_ph, deterministic=False,
                    generator=self.generator, eps=eps)
        losses = compute_loss(out, y_st, y_ph, y_raw, beta=beta)
        self.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        grad_norm = self.optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Mapping, beta: float) -> Dict[str, torch.Tensor]:
        """The deterministic forward (posterior mean, running statistics)
        and its losses; changes no state."""
        y_st, y_ph, x_ph, y_raw = self._batch(batch)
        out = self.model.eval()(y_st, y_ph, x_ph, deterministic=True)
        return compute_loss(out, y_st, y_ph, y_raw, beta=beta)
