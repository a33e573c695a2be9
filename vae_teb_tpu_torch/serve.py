"""Serving: raw FHR/UP windows in, SeqVaeTeb outputs out.

`WindowFrontend` turns raw (B, N) windows into the model's coefficients:
the phase-scattering frontend (scattering, phase and cross-phase families,
reduced rate) on the production selections, then TRIM steps (2 minutes)
trimmed from each end. The training step takes the same coefficients.

`InferenceServer` holds a model and a `WindowFrontend` on one device, the
CUDA card unless the caller names another.
`infer(fhr, up)` runs the whole serving path -> the deterministic forward
(posterior mean latent). `infer_coefficients(y_st, y_ph, x_ph)` starts
from precomputed coefficients, as the JAX package's `serve._inference_fn`
does.

Precision is fp32. On a CUDA device PyTorch runs float32 matmuls in full
fp32 by default, but cuDNN convolutions in TF32; callers that need the
JAX package's fp32 numbers set `torch.backends.cudnn.allow_tf32 = False`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .device import resolve_device
from .models import SeqVaeTeb
from .ops import PhaseScattering1D

TRIM = 30


class WindowFrontend:
    """Raw (B, N) FHR and UP windows -> trimmed (y_st, y_ph, x_ph), each
    (B, S, C), on the frontend's device. Needs no gradient."""

    def __init__(self, frontend: PhaseScattering1D):
        self.frontend = frontend
        sel = frontend.optimal_fhr_selection()
        self.phase_subset = sel["phase_selection"]["selected_indices"]
        self.cross_subset = sel["cross_selection"]["selected_indices"]
        frontend.plan(self.phase_subset, self.cross_subset)   # build once

    @torch.no_grad()
    def __call__(self, fhr: torch.Tensor, up: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
        out = self.frontend.analyze(fhr, up, phase_subset=self.phase_subset,
                                    cross_subset=self.cross_subset)
        n_out = out["scattering"].shape[-1]
        sl = slice(TRIM, n_out - TRIM)
        return tuple(out[k][:, :, sl].transpose(1, 2)
                     for k in ("scattering", "phase_corr", "cross_phase_corr"))


class InferenceServer:
    """A model and its frontend on one device: the CUDA card unless
    `device` names another (`device="cpu"`). The model moves there; the
    frontend is built on its own device (`PhaseScattering1D(device=)`),
    which should be the same."""

    def __init__(self, model: SeqVaeTeb, frontend: PhaseScattering1D,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.frontend = WindowFrontend(frontend)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def coefficients(self, fhr, up) -> Tuple[torch.Tensor, ...]:
        """Raw (B, N) windows -> trimmed (y_st, y_ph, x_ph), each (B, S, C)."""
        return self.frontend(self._tensor(fhr), self._tensor(up))

    @torch.inference_mode()
    def infer(self, fhr, up) -> Dict[str, torch.Tensor]:
        """Raw FHR and UP windows (B, N) -> the deterministic forward's
        outputs (z, linear_output, mu_pr, logvar_pr, mu_x, mu_prior,
        logvar_prior, mu_post, logvar_post)."""
        return self.model(*self.coefficients(fhr, up), deterministic=True)

    @torch.inference_mode()
    def infer_coefficients(self, y_st, y_ph, x_ph) -> Dict[str, torch.Tensor]:
        """Trimmed coefficients (B, S, 43/44/130) -> the deterministic
        forward's outputs."""
        return self.model(self._tensor(y_st), self._tensor(y_ph),
                          self._tensor(x_ph), deterministic=True)
