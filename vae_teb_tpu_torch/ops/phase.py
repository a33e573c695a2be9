"""Phase-harmonic correlation frontend and FHR/UP coefficient selection.

Port of `vae_teb_tpu.ops.phase`: the static pair table, the clinical
coefficient selections (44 within-channel and 130 cross-channel pairs for
the production J=11, Q=4, T=16 configuration), the float64-built
phi-decimation operator, and `PhaseScattering1D.analyze`, the fused
production forward that returns the scattering, phase and cross-phase
families from one padded FHR spectrum.

Only the reduced-rate correlation pipeline (`ops.phase_reduced`) is
ported; it is the production frontend. The exact full-rate path is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .filterbank import FilterBank, build_filter_bank
from .phase_reduced import DevicePlan, apply_reduced, build_reduced_plan
from .scattering import Scattering1D, reflect_pad, reflect_pad_indices, tukey_window


def _build_phi_decimation_operator_c128(n: int, pad_left: int,
                                        pad_right: int, n_padded: int,
                                        phi_f: np.ndarray, dec: int
                                        ) -> np.ndarray:
    """Dense complex128 (n -> n_out) operator equal to the chained
    phi-decimate of a complex input c:

        out = IFFT_keep( phi[:keep] * FFT_{n_padded}(reflect_pad(c))[:keep] )
              [start : start + n//dec]

    (the reference's `_apply_phi_filter`), composed in float64. The
    reduced-rate plan composes it with each rate group's reconstruction.
    """
    idx = reflect_pad_indices(n, pad_left, pad_right)        # (n_padded,)
    keep = n_padded // dec
    k = np.arange(keep, dtype=np.float64)
    j = np.arange(n_padded, dtype=np.float64)
    fwd = np.exp(-2j * np.pi * np.outer(k, j) / n_padded)    # (keep, n_pad)
    a = phi_f[:keep, None] * fwd
    t = np.arange(keep, dtype=np.float64)
    inv = np.exp(2j * np.pi * np.outer(t, k) / keep) / keep  # (keep, keep)
    l_pad = inv @ a                                          # (keep, n_pad)
    start = pad_left // dec
    n_out = min(start + n // dec, keep) - start
    l_pad = l_pad[start:start + n_out]
    lt_src = np.zeros((n, n_out), np.complex128)
    np.add.at(lt_src, idx, l_pad.T)                          # fold padding
    return lt_src


# ---------------------------------------------------------------------------
# Static pair table and coefficient selection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PairTable:
    """All ordered filter pairs (i, j) with xi_j >= xi_i.

    powers[k] = xi_j / xi_i is the phase-acceleration exponent; autoc_idx
    marks the i == j diagonal.
    """
    i_idx: np.ndarray
    j_idx: np.ndarray
    powers: np.ndarray
    autoc_idx: np.ndarray

    def __len__(self) -> int:
        return len(self.i_idx)


def build_pair_table(center_freqs: np.ndarray) -> PairTable:
    # float32 on purpose: the powers and selection thresholds are defined on
    # single-precision center frequencies, and exact power-of-two ratios
    # such as 32.0 sit on the selection boundary, where float64 would tip
    # them over it.
    xi = np.asarray(center_freqs, dtype=np.float32)
    n = len(xi)
    ii, jj, pw = [], [], []
    for i in range(n):
        for j in range(n):
            if xi[j] >= xi[i]:
                ii.append(i)
                jj.append(j)
                pw.append(np.float32(xi[j] / xi[i]) if xi[i] > 1e-8 else 1.0)
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    autoc = np.where(ii == jj)[0]
    return PairTable(i_idx=ii, j_idx=jj, powers=np.asarray(pw), autoc_idx=autoc)


def select_phase_coefficients(pairs: PairTable, center_freqs: np.ndarray,
                              min_freq: float = 0.006,
                              max_harmonic_power: float = 8.0,
                              include_autocorr: bool = True,
                              harmonic_ratios: Sequence[int] = (2, 3),
                              power_tolerance: float = 0.1) -> Dict:
    """Within-channel pair selection: autocorrelations plus near-integer
    harmonic ratios, restricted to clinically relevant frequencies."""
    xi = np.asarray(center_freqs)
    freq_ok = xi >= min_freq
    masks = {}
    if include_autocorr:
        auto = np.zeros(len(pairs), dtype=bool)
        auto[pairs.autoc_idx] = True
        masks["autocorr"] = freq_ok[pairs.i_idx] & freq_ok[pairs.j_idx] & auto
    for ratio in harmonic_ratios:
        near = np.abs(pairs.powers - ratio) < power_tolerance
        masks[f"harmonic_{ratio}"] = (
            freq_ok[pairs.i_idx] & freq_ok[pairs.j_idx]
            & near & (pairs.powers <= max_harmonic_power))
    optimal = np.zeros(len(pairs), dtype=bool)
    for m in masks.values():
        optimal |= m
    return {
        "masks": masks,
        "optimal_mask": optimal,
        "selected_indices": np.where(optimal)[0],
        "n_selected": int(optimal.sum()),
    }


def select_cross_coefficients(pairs: PairTable, center_freqs: np.ndarray,
                              up_max_freq: float = 0.02,
                              fhr_min_freq: float = 0.04,
                              fhr_max_freq: float = 0.5,
                              max_harmonic_power: float = 32.0) -> Dict:
    """Cross-channel (UP -> FHR) pair selection: slow contraction-band
    filters on the source channel against variability-band filters on the
    target channel."""
    xi = np.asarray(center_freqs)
    up_band = xi < up_max_freq
    fhr_band = (xi >= fhr_min_freq) & (xi <= fhr_max_freq)
    mask = (up_band[pairs.i_idx] & fhr_band[pairs.j_idx]
            & (pairs.powers >= 1.0) & (pairs.powers <= max_harmonic_power))
    return {
        "cross_mask": mask,
        "up_band_mask": up_band,
        "fhr_band_mask": fhr_band,
        "selected_indices": np.where(mask)[0],
        "n_selected": int(mask.sum()),
    }


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------

class PhaseScattering1D:
    """Scattering + reduced-rate phase-harmonic correlations.

    `analyze(fhr, up)` produces the three coefficient families the VAE
    consumes, each (B, C, N_out) float32:
      scattering        (B, 1 + C1, N/T)
      phase_corr        (B, P_phase, N/T)  within-channel FHR harmonics
      cross_phase_corr  (B, P_cross, N/T)  UP -> FHR cross-channel

    correlation_dtype=torch.bfloat16 stores the pair-rate products and the
    decimation operators in bf16 (accumulated in fp32); None keeps fp32.
    """

    def __init__(self, J: int, Q: int, T: int, shape: int,
                 tukey_alpha: Optional[float] = None,
                 correlation_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None):
        self.J, self.Q, self.T, self.N = J, Q, T, int(shape)
        self.correlation_dtype = correlation_dtype
        self.device = torch.device(device) if device is not None else None

        fb = build_filter_bank(J, Q, T, self.N)
        self.fb: FilterBank = fb
        self.scattering = Scattering1D(J, Q, T, shape, filter_bank=fb,
                                       device=device)
        self.center_freqs = fb.psi1_xi.astype(np.float32)
        self.pairs = build_pair_table(self.center_freqs)
        self.pad_left, self.pad_right = fb.pad_left, fb.pad_right
        self.N_padded = fb.N_padded

        # decimation that lines the phase outputs up with the scattering grid
        t_out = self.scattering.n_out
        self.decimation = max(1, self.N // t_out) if self.N > t_out else 1

        self._window = (torch.as_tensor(tukey_window(self.N, tukey_alpha),
                                        dtype=torch.float32, device=device)
                        if tukey_alpha else None)
        self._plans: Dict[Tuple, DevicePlan] = {}

    def phi_lt_src(self) -> np.ndarray:
        """Complex128 (N, n_out) phi-decimation operator of this geometry."""
        return _build_phi_decimation_operator_c128(
            self.N, self.pad_left, self.pad_right, self.N_padded,
            np.asarray(self.fb.phi_levels[0], np.float64), self.decimation)

    def plan(self, phase_subset: Sequence[int],
             cross_subset: Optional[Sequence[int]]) -> DevicePlan:
        """The reduced-rate plan for these subsets, built once per instance
        and kept on the frontend's device."""
        key = (tuple(int(i) for i in phase_subset),
               None if cross_subset is None
               else tuple(int(i) for i in cross_subset))
        if key not in self._plans:
            host = build_reduced_plan(self, key[0], key[1])
            self._plans[key] = DevicePlan(host, self.N_padded,
                                          self.correlation_dtype, self.device)
        return self._plans[key]

    def analyze(self, fhr: torch.Tensor, up: Optional[torch.Tensor] = None,
                phase_subset: Optional[Sequence[int]] = None,
                cross_subset: Optional[Sequence[int]] = None
                ) -> Dict[str, torch.Tensor]:
        """Production forward: all three coefficient families at once.

        fhr, up: (B, N) real signals. `phase_subset` defaults to the optimal
        FHR selection, `cross_subset` (which needs `up`) to the UP -> FHR
        selection. FHR is padded and transformed once; it feeds the
        scattering and both correlation families, and one `apply_reduced`
        computes both families.
        """
        if fhr.ndim != 2 or fhr.shape[-1] != self.N:
            raise ValueError(f"fhr must be (B, {self.N}), got {tuple(fhr.shape)}")
        if up is not None and up.shape != fhr.shape:
            raise ValueError("up must match fhr's shape")
        sel = self.optimal_fhr_selection()
        if phase_subset is None:
            phase_subset = sel["phase_selection"]["selected_indices"]
        if up is None:
            cross_subset = None
        elif cross_subset is None:
            cross_subset = sel["cross_selection"]["selected_indices"]

        fhr = fhr.to(torch.float32)
        if self._window is not None:
            fhr = fhr * self._window
            if up is not None:
                up = up.to(torch.float32) * self._window
        spec_fhr = torch.fft.fft(reflect_pad(fhr, self.pad_left,
                                             self.pad_right))
        out = {"scattering": self.scattering.scatter_spectrum(spec_fhr)}
        plan = self.plan(phase_subset, cross_subset)
        if cross_subset is not None:
            spec_up = torch.fft.fft(reflect_pad(up.to(torch.float32),
                                                self.pad_left, self.pad_right))
        else:
            spec_up = spec_fhr
        pc, cc = apply_reduced(plan, spec_fhr, spec_up)
        out["phase_corr"] = pc
        if cc is not None:
            out["cross_phase_corr"] = cc
        return out

    def optimal_fhr_selection(self) -> Dict:
        """Both selections and their masks. min_freq follows the reference's
        J-dependent policy: 0.006 for J >= 11 (the clinical band), 0.003
        for smaller J to keep enough scales."""
        min_freq = 0.006 if self.J >= 11 else 0.003
        phase_sel = select_phase_coefficients(self.pairs, self.center_freqs,
                                              min_freq=min_freq)
        cross_sel = select_cross_coefficients(self.pairs, self.center_freqs)
        return {
            "phase_selection": phase_sel,
            "cross_selection": cross_sel,
            "use_phase_mask": phase_sel["optimal_mask"],
            "use_cross_mask": cross_sel["cross_mask"],
            "total_selected_features": (self.scattering.output_channels
                                        + phase_sel["n_selected"]
                                        + cross_sel["n_selected"]),
        }
