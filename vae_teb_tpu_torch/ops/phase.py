"""Phase-harmonic correlation frontend and FHR/UP coefficient selection.

Port of `vae_teb_tpu.ops.phase`: the static pair table, the clinical
coefficient selections (44 within-channel and 130 cross-channel pairs for
the production J=11, Q=4, T=16 configuration), the float64-built
phi-decimation operator, and `PhaseScattering1D` with both correlation
pipelines:

  - exact (`reduced_rate=False`, the default, as in the JAX package): the
    analytic band signals at the full rate, accelerated conjugate products
    of every selected pair, then the dense phi-decimation operator as two
    real GEMMs (`_phi_decimate`);
  - reduced rate (`reduced_rate=True`, the production serving and training
    frontend): `ops.phase_reduced`, each pair at the lowest alias-safe rate.

Complex signals are complex64 tensors; the pair-rate products are kept as
(real, imaginary) float tensors so `correlation_dtype=torch.bfloat16` can
store them in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .filterbank import FilterBank, build_filter_bank
from .phase_reduced import (SUPPORT_THRESHOLD, DevicePlan, apply_reduced,
                            build_reduced_plan)
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

def _subset_key(subset: Optional[Sequence[int]]) -> Optional[Tuple[int, ...]]:
    return None if subset is None else tuple(int(i) for i in subset)


class PhaseScattering1D:
    """Scattering + phase-harmonic correlations.

    Produces the three coefficient families the VAE consumes, each
    (B, C, N_out) float32:
      scattering        (B, 1 + C1 [+ C2], N/T)
      phase_corr        (B, P_phase, N/T)  within-channel FHR harmonics
      cross_phase_corr  (B, P_cross, N/T)  cross-channel, channel 0 (FHR)
                                           accelerated against channel 1 (UP)

    `__call__` computes any family over all pairs or a pair subset;
    `analyze(fhr, up)` is the fused forward of all three. `reduced_rate`
    selects the correlation pipeline of the subset paths (module doc).
    `correlation_dtype=torch.bfloat16` stores the pair-rate products and
    the decimation operators in bf16, accumulated in fp32; None keeps
    fp32. Constants live on `device` (default the CPU); inputs must be
    there too.
    """

    def __init__(self, J: int, Q: int, T: int, shape: int,
                 max_order: int = 1, oversampling: int = 0,
                 tukey_alpha: Optional[float] = None,
                 correlation_dtype: Optional[torch.dtype] = None,
                 reduced_rate: bool = False,
                 support_threshold: float = SUPPORT_THRESHOLD,
                 device: Optional[torch.device] = None):
        self.J, self.Q, self.T, self.N = J, Q, T, int(shape)
        self.tukey_alpha = tukey_alpha
        self.correlation_dtype = correlation_dtype
        self.reduced_rate = reduced_rate
        self.support_threshold = support_threshold
        self.device = torch.device(device if device is not None else "cpu")

        fb = build_filter_bank(J, Q, T, self.N)
        self.fb: FilterBank = fb
        self.scattering = Scattering1D(J, Q, T, shape, max_order=max_order,
                                       oversampling=oversampling,
                                       filter_bank=fb, device=self.device)
        self.center_freqs = fb.psi1_xi.astype(np.float32)
        self.pairs = build_pair_table(self.center_freqs)
        self.psi1_f = self.scattering.psi1_f
        self.phi_f = self.scattering.phi0_f
        self.pad_left, self.pad_right = fb.pad_left, fb.pad_right
        self.N_padded = fb.N_padded

        # decimation that lines the phase outputs up with the scattering grid
        t_out = self.scattering.n_out
        self.decimation = max(1, self.N // t_out) if self.N > t_out else 1

        self._window = (self._const(tukey_window(self.N, tukey_alpha),
                                    torch.float32)
                        if tukey_alpha else None)
        self._decim = None
        self._plans: Dict[Tuple, DevicePlan] = {}
        self._indices: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    # -- constants, built once per instance and kept on the device ----------

    def phi_lt_src(self) -> np.ndarray:
        """Complex128 (N, n_out) phi-decimation operator of this geometry,
        built anew on each call: only plan building and the device
        operators read it, once each."""
        return _build_phi_decimation_operator_c128(
            self.N, self.pad_left, self.pad_right, self.N_padded,
            np.asarray(self.fb.phi_levels[0], np.float64), self.decimation)

    def _decimation_operators(self):
        """((Lr, Li), low-precision (Lr, Li) or None), each (N, n_out)
        float32 with Re(c @ L) = cr @ Lr - ci @ Li; None when the
        decimation is 1 (the FFT path then runs). The low-precision pair
        holds the operator rounded to `correlation_dtype`: products of
        bf16 values are exact in fp32, so an fp32 GEMM of the rounded
        operands is the bf16 matmul with fp32 accumulation."""
        if self.decimation == 1:
            return None
        if self._decim is None:
            lt = self.phi_lt_src()
            full = tuple(self._const(np.ascontiguousarray(part),
                                     torch.float32)
                         for part in (lt.real, lt.imag))
            low = (None if self.correlation_dtype is None else
                   tuple(m.to(self.correlation_dtype).float() for m in full))
            self._decim = (full, low)
        return self._decim

    def plan(self, phase_subset: Optional[Sequence[int]],
             cross_subset: Optional[Sequence[int]]) -> DevicePlan:
        """The reduced-rate plan for these subsets (None: no such family),
        built once per instance and kept on the frontend's device."""
        key = (_subset_key(phase_subset), _subset_key(cross_subset))
        if key not in self._plans:
            host = build_reduced_plan(self, key[0], key[1],
                                      self.support_threshold)
            self._plans[key] = DevicePlan(host, self.N_padded,
                                          self.correlation_dtype, self.device)
        return self._plans[key]

    def _const(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _subset(self, subset: Optional[Sequence[int]]):
        """(i_idx, j_idx, powers) of all pairs or of a subset, on the device."""
        key = ("pairs", _subset_key(subset))
        if key not in self._indices:
            sel = slice(None) if subset is None else np.asarray(key[1])
            pr, t = self.pairs, self._const
            self._indices[key] = (t(pr.i_idx[sel]), t(pr.j_idx[sel]),
                                  t(pr.powers[sel], torch.float32))
        return self._indices[key]

    def _banded_indices(self, phase_subset, cross_subset):
        """Band rows and pair positions of the exact subset paths, on the
        device: (phase rows, phase ip, phase jp, phase powers) over the
        bands both sides read from the i-channel, then, with a cross
        subset, (cross ip into those rows, j-channel rows, cross jp, cross
        powers). A phase subset of None reads no phase pair."""
        key = ("banded", _subset_key(phase_subset), _subset_key(cross_subset))
        if key not in self._indices:
            pr, t = self.pairs, self._const
            p = np.asarray(key[1] or (), np.int64)
            pii, pjj = pr.i_idx[p], pr.j_idx[p]
            used = [pii, pjj]
            if key[2] is not None:
                c = np.asarray(key[2], np.int64)
                cii, cjj = pr.i_idx[c], pr.j_idx[c]
                used.append(cii)
            rows = np.unique(np.concatenate(used))
            out = (t(rows), t(np.searchsorted(rows, pii)),
                   t(np.searchsorted(rows, pjj)),
                   t(pr.powers[p], torch.float32))
            if key[2] is not None:
                rows_j = np.unique(cjj)
                out += (t(np.searchsorted(rows, cii)), t(rows_j),
                        t(np.searchsorted(rows_j, cjj)),
                        t(pr.powers[c], torch.float32))
            self._indices[key] = out
        return self._indices[key]

    # -- building blocks ----------------------------------------------------

    def _spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """Padded complex spectrum (..., N_padded) of real signals (..., N)."""
        return torch.fft.fft(reflect_pad(x.to(torch.float32), self.pad_left,
                                         self.pad_right))

    def _filter_all(self, x: torch.Tensor,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """First-order wavelets: (..., N) real -> (..., C, N) complex64
        analytic band signals; `rows` restricts to a filter subset."""
        return self._bands_from_spectrum(self._spectrum(x), rows)

    def _bands_from_spectrum(self, spec: torch.Tensor,
                             rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """Analytic band signals from the PADDED spectrum (..., N_padded)."""
        filt = self.psi1_f if rows is None else self.psi1_f[rows]
        bands = torch.fft.ifft(spec[..., None, :] * filt)
        return bands[..., self.pad_left:self.pad_left + self.N]

    def _phi_decimate(self, cr: torch.Tensor, ci: torch.Tensor
                      ) -> torch.Tensor:
        """Low-pass and frequency-domain decimation of complex correlations
        cr + i ci (..., N) -> real (..., n_out) float32: re-pad, FFT,
        multiply phi, keep the N_padded/dec lowest bins, IFFT, unpad with
        decimated border arithmetic, real part. With a decimation the whole
        chain is the dense operator (two GEMMs, fp32 accumulation; bf16
        operands when the products are in `correlation_dtype`); without
        one, the FFT chain in fp32."""
        ops = self._decimation_operators()
        if ops is not None:
            full, low = ops
            lr, li = (low if low is not None
                      and cr.dtype == self.correlation_dtype else full)
            return cr.float() @ lr - ci.float() @ li
        c = torch.complex(cr.float(), ci.float())
        h = torch.fft.fft(reflect_pad(c, self.pad_left, self.pad_right))
        dec = self.decimation
        keep = self.N_padded // dec
        s = torch.fft.ifft(h[..., :keep] * self.phi_f[:keep]).real
        start = self.pad_left // dec
        return s[..., start:min(start + self.N // dec, s.shape[-1])]

    @staticmethod
    def _accelerate(z: torch.Tensor, power: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A e^{i phi} -> A e^{i power phi}, as (real, imaginary)."""
        mag = z.abs()
        ph = torch.angle(z) * power
        return mag * torch.cos(ph), mag * torch.sin(ph)

    def _conj_product(self, ar, ai, zj):
        """(ar + i ai) * conj(zj) as (real, imaginary), the four operands
        cast to `correlation_dtype` first: the polar math stays fp32."""
        jr, ji = zj.real, zj.imag
        dt = self.correlation_dtype
        if dt is not None:
            ar, ai, jr, ji = ar.to(dt), ai.to(dt), jr.to(dt), ji.to(dt)
        return ar * jr + ai * ji, ai * jr - ar * ji

    def _pair_correlation(self, zi, zj, powers) -> torch.Tensor:
        """Accelerated conjugate products of gathered pair operands
        (..., P, N), low-passed and decimated."""
        ar, ai = self._accelerate(zi, powers[:, None])
        return self._phi_decimate(*self._conj_product(ar, ai, zj))

    def _banded_product(self, zi_b, ip, zj_b, jp, powers):
        """Accelerated conjugate products from BAND tensors and pair
        positions: the modulus and angle run once per band, only cos, sin
        and the product at pair rate. Same values as gather-then-accelerate."""
        mag, ph = zi_b.abs(), torch.angle(zi_b)
        phs = ph[:, ip] * powers[:, None]
        a = mag[:, ip]
        return self._conj_product(a * torch.cos(phs), a * torch.sin(phs),
                                  zj_b[:, jp])

    # -- public API -----------------------------------------------------------

    def phase_correlation(self, filtered: torch.Tensor,
                          subset: Optional[Sequence[int]] = None
                          ) -> torch.Tensor:
        """Complex (B, C1, N) band signals -> (B, P, N/dec) real."""
        ii, jj, pw = self._subset(subset)
        return self._pair_correlation(filtered[:, ii], filtered[:, jj], pw)

    def cross_phase_correlation(self, filtered: torch.Tensor,
                                subset: Optional[Sequence[int]] = None,
                                apply_low_pass: bool = True) -> torch.Tensor:
        """Complex (B, 2, C1, N) -> (B, P, N/dec) real, channel 0
        accelerated against channel 1's conjugate; without the low-pass the
        real part of the full-rate products (B, P, N)."""
        ii, jj, pw = self._subset(subset)
        zi, zj = filtered[:, 0, ii], filtered[:, 1, jj]
        if not apply_low_pass:
            ar, ai = self._accelerate(zi, pw[:, None])
            return ar * zj.real + ai * zj.imag
        return self._pair_correlation(zi, zj, pw)

    def __call__(self, x: torch.Tensor, compute_phase: bool = True,
                 compute_cross_phase: bool = False,
                 phase_subset: Optional[Sequence[int]] = None,
                 cross_subset: Optional[Sequence[int]] = None,
                 compute_scattering: bool = True) -> Dict[str, torch.Tensor]:
        """x: (B, N) or (B, C, N). Cross-phase needs C == 2: channel 0 is
        accelerated (FHR in the ETL), channel 1 conjugated (UP). A subset
        restricts a family to those pairs (None: all pairs); with
        `reduced_rate` the subset paths run the reduced-rate pipeline."""
        if x.ndim not in (2, 3):
            raise ValueError(f"input must be (B, N) or (B, C, N), got "
                             f"{tuple(x.shape)}")
        if x.shape[-1] != self.N:
            raise ValueError(f"signal length {x.shape[-1]} != configured "
                             f"N={self.N}")
        if compute_cross_phase and (x.ndim != 3 or x.shape[1] != 2):
            raise ValueError("cross-channel correlation requires (B, 2, N) "
                             "input with channel 0 = source, channel 1 = "
                             "target")
        x = x.to(torch.float32)
        if self._window is not None:
            x = x * self._window
        sig = x[:, 0, :] if x.ndim == 3 else x
        out = {}
        if compute_scattering:
            out["scattering"] = self.scattering(sig)
        if compute_cross_phase:
            if cross_subset is not None and self.reduced_rate:
                _, out["cross_phase_corr"] = apply_reduced(
                    self.plan(None, cross_subset), self._spectrum(x[:, 0]),
                    self._spectrum(x[:, 1]))
            elif cross_subset is not None:
                # only the bands the selected pairs touch, per channel
                rows, _, _, _, cip, rows_j, cjp, cpw = self._banded_indices(
                    None, cross_subset)
                zi = self._filter_all(x[:, 0], rows)
                zj = self._filter_all(x[:, 1], rows_j)
                out["cross_phase_corr"] = self._phi_decimate(
                    *self._banded_product(zi, cip, zj, cjp, cpw))
            else:
                out["cross_phase_corr"] = self.cross_phase_correlation(
                    self._filter_all(x))
        if compute_phase:
            if phase_subset is not None and self.reduced_rate:
                spec = self._spectrum(sig)
                out["phase_corr"], _ = apply_reduced(
                    self.plan(phase_subset, None), spec, spec)
            elif phase_subset is not None:
                rows, ip, jp, pw = self._banded_indices(phase_subset, None)
                z = self._filter_all(sig, rows)
                out["phase_corr"] = self._phi_decimate(
                    *self._banded_product(z, ip, z, jp, pw))
            else:
                out["phase_corr"] = self.phase_correlation(
                    self._filter_all(sig))
        return out

    def analyze(self, fhr: torch.Tensor, up: Optional[torch.Tensor] = None,
                phase_subset: Optional[Sequence[int]] = None,
                cross_subset: Optional[Sequence[int]] = None,
                compute_scattering: bool = True
                ) -> Dict[str, torch.Tensor]:
        """Production forward: all three coefficient families at once.

        fhr, up: (B, N) real signals. `phase_subset` defaults to the optimal
        FHR selection, `cross_subset` (which needs `up`) to the UP -> FHR
        selection. FHR is padded and transformed once; its spectrum feeds
        the scattering and both correlation families. Reduced rate: one
        `apply_reduced` computes both families. Exact: the FHR bands of
        every selected pair come from that spectrum once, and both
        families share one decimation.
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
        if up is not None:
            up = up.to(torch.float32)
        if self._window is not None:
            fhr = fhr * self._window
            if up is not None:
                up = up * self._window
        spec_fhr = self._spectrum(fhr)
        out = {}
        if compute_scattering:
            out["scattering"] = self.scattering.scatter_spectrum(spec_fhr)
        if self.reduced_rate:
            spec_up = spec_fhr if up is None else self._spectrum(up)
            pc, cc = apply_reduced(self.plan(phase_subset, cross_subset),
                                   spec_fhr, spec_up)
        else:
            pc, cc = self._analyze_exact(spec_fhr, up, phase_subset,
                                         cross_subset)
        out["phase_corr"] = pc
        if cc is not None:
            out["cross_phase_corr"] = cc
        return out

    def _analyze_exact(self, spec_fhr, up, phase_subset, cross_subset):
        """The exact families of `analyze`: the FHR bands both families
        read, one banded product per family, one decimation."""
        idx = self._banded_indices(phase_subset, cross_subset)
        rows, ip, jp, pw = idx[:4]
        z = self._bands_from_spectrum(spec_fhr, rows)
        cr, ci = self._banded_product(z, ip, z, jp, pw)
        if cross_subset is None:
            return self._phi_decimate(cr, ci), None
        cip, rows_j, cjp, cpw = idx[4:]
        zu = self._filter_all(up, rows_j)
        xr, xi = self._banded_product(z, cip, zu, cjp, cpw)
        dec = self._phi_decimate(torch.cat([cr, xr], dim=1),
                                 torch.cat([ci, xi], dim=1))
        n_p = cr.shape[1]
        return dec[:, :n_p], dec[:, n_p:]

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

    def verify_phase_correlation_properties(self, x, tol: float = 1e-6
                                            ) -> Dict:
        """Self-checks: autocorrelations non-negative (on the first signal,
        all pairs), center frequencies ordered within each pair, powers
        >= 1. x: (B, N) or (B, C, N), numpy or a tensor."""
        results = {"passed": True, "details": {}}
        x = self._const(x, torch.float32)
        xt = x[:1] if x.ndim == 2 else x[:1, 0]
        pc = self.phase_correlation(self._filter_all(xt))
        auto = pc[0, self._const(self.pairs.autoc_idx)].cpu().numpy()
        if np.any(auto < -tol):
            results["passed"] = False
            results["details"]["autocorr_negative"] = float(auto.min())
        xi = self.center_freqs
        if np.any(xi[self.pairs.j_idx] < xi[self.pairs.i_idx] - tol):
            results["passed"] = False
            results["details"]["frequency_ordering"] = True
        if np.any(self.pairs.powers < 1.0 - tol):
            results["passed"] = False
            results["details"]["invalid_powers"] = True
        return results
