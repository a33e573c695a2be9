"""Serving: raw FHR/UP windows in, SeqVaeTeb outputs out.

`InferenceServer` holds a model and its phase-scattering frontend on one
device. `infer(fhr, up)` runs the whole serving path on raw (B, N) windows:
frontend (scattering, phase and cross-phase families, reduced rate) ->
trim TRIM steps (2 minutes) from each end -> the deterministic forward
(posterior mean latent). `infer_coefficients(y_st, y_ph, x_ph)` starts from
precomputed coefficients, as the JAX package's `serve._inference_fn` does.

Precision is fp32. On a CUDA device PyTorch runs float32 matmuls in full
fp32 by default, but cuDNN convolutions in TF32; callers that need the
JAX package's fp32 numbers set `torch.backends.cudnn.allow_tf32 = False`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .models import SeqVaeTeb
from .ops import PhaseScattering1D

TRIM = 30


class InferenceServer:

    def __init__(self, model: SeqVaeTeb, frontend: PhaseScattering1D, device):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.frontend = frontend
        sel = frontend.optimal_fhr_selection()
        self.phase_subset = sel["phase_selection"]["selected_indices"]
        self.cross_subset = sel["cross_selection"]["selected_indices"]
        frontend.plan(self.phase_subset, self.cross_subset)   # build once

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def coefficients(self, fhr, up) -> Tuple[torch.Tensor, ...]:
        """Raw (B, N) windows -> trimmed (y_st, y_ph, x_ph), each (B, S, C)."""
        out = self.frontend.analyze(self._tensor(fhr), self._tensor(up),
                                    phase_subset=self.phase_subset,
                                    cross_subset=self.cross_subset)
        n_out = out["scattering"].shape[-1]
        sl = slice(TRIM, n_out - TRIM)
        return tuple(out[k][:, :, sl].transpose(1, 2)
                     for k in ("scattering", "phase_corr", "cross_phase_corr"))

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
