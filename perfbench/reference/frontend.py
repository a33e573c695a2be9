"""Plain reference of the serving frontend: raw (B, N) FHR and UP windows ->
the trimmed coefficient families (y_st, y_ph, x_ph), each (B, S, C).

What it computes is what the production frontend is defined to compute:
first-order scattering (order 0 and every first-order filter), and the
within-channel (FHR) and cross-channel (FHR accelerated against UP)
phase-harmonic correlations of the clinical pair selections, each pair
run at the lowest power-of-two rate that keeps its measured spectral
support alias-free (the reduced-rate pipeline), then trimmed. Every
operator is built here from the frozen filter bank in float64 and
applied in float64 (complex128 spectra), with direct FFTs where the
program folds chains into dense operators.

`Precision` lowers it for the control: float32 / complex64 arithmetic
with the operands of every product rounded by a rounding function (TF32),
which is what a lower-precision implementation of the same frontend
would compute.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .filterbank import FilterBank, build_filter_bank, reflect_pad_indices
from .precision import Precision

SUPPORT_THRESHOLD = 3e-4


# ---------------------------------------------------------------------------
# pair table and the clinical selections
# ---------------------------------------------------------------------------

def pair_table(xi: np.ndarray):
    """All ordered pairs (i, j) with xi_j >= xi_i, and their acceleration
    powers xi_j / xi_i, on float32 centre frequencies (the selections'
    thresholds are defined on them)."""
    xi = np.asarray(xi, dtype=np.float32)
    ii, jj, pw = [], [], []
    for i in range(len(xi)):
        for j in range(len(xi)):
            if xi[j] >= xi[i]:
                ii.append(i)
                jj.append(j)
                pw.append(np.float32(xi[j] / xi[i]) if xi[i] > 1e-8 else 1.0)
    return np.asarray(ii), np.asarray(jj), np.asarray(pw)


def selections(xi: np.ndarray, J: int) -> Tuple[np.ndarray, np.ndarray]:
    """(phase subset, cross subset): autocorrelations and near-2 and near-3
    harmonics of clinically relevant FHR filters; slow UP filters against
    FHR variability-band filters."""
    xi = np.asarray(xi, dtype=np.float32)
    ii, jj, pw = pair_table(xi)
    min_freq = 0.006 if J >= 11 else 0.003
    ok = xi >= min_freq
    phase = ok[ii] & ok[jj] & (ii == jj)
    for ratio in (2, 3):
        phase |= ok[ii] & ok[jj] & (np.abs(pw - ratio) < 0.1) & (pw <= 8.0)
    up_band = xi < 0.02
    fhr_band = (xi >= 0.04) & (xi <= 0.5)
    cross = up_band[ii] & fhr_band[jj] & (pw >= 1.0) & (pw <= 32.0)
    return np.where(phase)[0], np.where(cross)[0]


# ---------------------------------------------------------------------------
# the reduced-rate plan (float64 throughout)
# ---------------------------------------------------------------------------

def phi_decimation_operator(fb: FilterBank, dec: int) -> np.ndarray:
    """Complex128 (N, n_out): reflect pad, FFT, phi low-pass, keep the
    N_padded / dec lowest bins, inverse FFT, unpad at the decimated rate."""
    n, n_padded = fb.N, fb.N_padded
    idx = reflect_pad_indices(n, fb.pad_left, fb.pad_right)
    keep = n_padded // dec
    k = np.arange(keep, dtype=np.float64)
    j = np.arange(n_padded, dtype=np.float64)
    a = fb.phi_levels[0][:keep, None] * np.exp(-2j * np.pi * np.outer(k, j)
                                               / n_padded)
    inv = np.exp(2j * np.pi * np.outer(k, k) / keep) / keep
    l_pad = inv @ a
    start = fb.pad_left // dec
    n_out = min(start + n // dec, keep) - start
    lt = np.zeros((n, n_out), np.complex128)
    np.add.at(lt, idx, l_pad[start:start + n_out].T)
    return lt


def _support(filt: np.ndarray, center: int, thr: float) -> Tuple[int, int]:
    n = len(filt)
    rolled = np.roll(filt, n // 2 - center)
    idx = np.where(np.abs(rolled) > thr * np.abs(filt).max())[0]
    return int(idx.min()) - n // 2 + center, int(idx.max()) - n // 2 + center


def reduced_plan(fb: FilterBank, dec: int, phase: Sequence[int],
                 cross: Sequence[int]) -> List[Dict]:
    """One entry per decimation ds: the band slots (side, band) each pair
    reads, the pairs' slots and powers, and the composed (W, n_out)
    reconstruction-and-decimation operator."""
    n_padded = fb.N_padded
    psi, phi = fb.psi1, fb.phi_levels[0]
    ii, jj, pw = pair_table(fb.psi1_xi)
    centers = np.rint(fb.psi1_xi.astype(np.float32).astype(np.float64)
                      * n_padded).astype(np.int64)
    sup = [_support(psi[b], int(centers[b]), SUPPORT_THRESHOLD)
           for b in range(psi.shape[0])]
    half_phi = int(np.where(np.abs(phi[:n_padded // 2])
                            > SUPPORT_THRESHOLD * phi.max())[0].max()) + 1
    by_ds: Dict[int, list] = {}
    for family, subset in ((0, phase), (1, cross)):
        for pos, k in enumerate(subset):
            i, j, p = int(ii[k]), int(jj[k]), float(pw[k])
            c_i, c_j = int(centers[i]), int(centers[j])
            lo = p * (sup[i][0] - c_i) - (sup[j][1] - c_j) + p * c_i - c_j
            hi = p * (sup[i][1] - c_i) - (sup[j][0] - c_j) + p * c_i - c_j
            half = max(abs(lo), abs(hi))
            ds = 1
            for d in (16, 8, 4, 2):
                if half < (n_padded // d) / 2 - half_phi - 8:
                    ds = d
                    break
            by_ds.setdefault(ds, []).append((family, pos, i, j, p))
    lt = phi_decimation_operator(fb, dec)
    groups = []
    for ds in sorted(by_ds):
        W = n_padded // ds
        slots: Dict[Tuple[int, int], int] = {}
        pairs = []
        for family, pos, i, j, p in by_ds[ds]:
            si = slots.setdefault((0, i), len(slots))
            sj = slots.setdefault((0 if family == 0 else 1, j), len(slots))
            pairs.append((family, pos, si, sj, p))
        offs = np.concatenate([np.arange(0, W // 2), np.arange(-W // 2, 0)])
        ms = np.arange(W, dtype=np.int64)
        side = np.zeros(len(slots), np.int64)
        bins = np.zeros((len(slots), W), np.int64)
        win = np.zeros((len(slots), W))
        ramp = np.zeros((len(slots), W))
        for (sd, band), s in slots.items():
            c = int(centers[band])
            side[s] = sd
            bins[s] = (c + offs) % n_padded
            win[s] = psi[band][bins[s]] / ds
            ramp[s] = 2.0 * np.pi * ((c * ds * ms) % n_padded) / n_padded
        # Dirichlet reconstruction of the W-rate band-limited signal on the
        # padded circle, composed with the phi decimation of the unpadded
        # slice: sum_n e^{2 pi i k n / Np} lt[n - pad_left], then a W-point DFT
        placed = np.zeros((n_padded, lt.shape[1]), np.complex128)
        placed[fb.pad_left:fb.pad_left + fb.N] = lt
        spec = n_padded * np.fft.ifft(placed, axis=0)[offs % n_padded]
        M = np.fft.fft(spec, axis=0) / W
        fam, pos, si, sj, p = (np.asarray(c) for c in zip(*pairs))
        groups.append(dict(W=W, side=side, bins=bins, win=win, ramp=ramp,
                           ip=si, jp=sj, powers=p.astype(np.float64),
                           family=fam, pos=pos, M=M))
    return groups


# ---------------------------------------------------------------------------
# the transform
# ---------------------------------------------------------------------------

class Frontend:
    """The production frontend's definition (J, Q, T, N from the
    configuration), order 1, reduced rate, trimmed by `trim` steps a side.
    Constants live on `device`; `precision` picks float64 (None) or the
    control's lowered arithmetic."""

    def __init__(self, J: int, Q: int, T: int, N: int, trim: int,
                 device="cpu", precision: Optional[Precision] = None):
        self.fb = fb = build_filter_bank(J, Q, T, N)
        self.trim = trim
        self.pol = precision or Precision()
        self.real = self.pol.real
        self.complex = torch.complex64 if self.real == torch.float32 \
            else torch.complex128
        self.device = torch.device(device)
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=self.device)
        self.pad_idx = t(reflect_pad_indices(N, fb.pad_left, fb.pad_right))
        self.k0 = fb.log2_T
        self.psi1 = t(fb.psi1, self.real)
        self.phi = [t(p, self.real) for p in fb.phi_levels]
        self.k1 = np.maximum(np.minimum(fb.psi1_j, fb.log2_T), 0)
        self.lowpass = {int(k): t(self._lowpass(int(k)), self.real)
                        for k in set(self.k1.tolist())}
        n_out = int(fb.ind_end[self.k0] - fb.ind_start[self.k0])
        dec = max(1, N // n_out) if N > n_out else 1
        self.phase, self.cross = selections(fb.psi1_xi, J)
        self.groups = []
        for g in reduced_plan(fb, dec, self.phase, self.cross):
            self.groups.append(dict(
                idx=t(g["side"][:, None] * fb.N_padded + g["bins"]),
                win=t(g["win"], self.real), ramp=t(g["ramp"], self.real),
                ip=t(g["ip"]), jp=t(g["jp"]),
                powers=t(g["powers"][:, None], self.real),
                family=g["family"], pos=g["pos"],
                Mr=t(g["M"].real, self.real), Mi=t(g["M"].imag, self.real)))

    def _lowpass(self, k1: int) -> np.ndarray:
        """(M, n_out) float64: a real signal of length M = N_padded / 2^k1
        -> its phi low-pass (circular convolution with phi's time-domain
        filter), decimated by 2^kj and unpadded: column t reads the filter
        at 2^kj (i0 + t) - n."""
        fb = self.fb
        kj = max(fb.log2_T - k1, 0)
        g = np.fft.ifft(fb.phi_levels[k1]).real
        m = len(g)
        i0, i1 = int(fb.ind_start[k1 + kj]), int(fb.ind_end[k1 + kj])
        taps = (2 ** kj * np.arange(i0, i1)[None, :]
                - np.arange(m)[:, None]) % m
        return g[taps]

    def _spectrum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.real).index_select(-1, self.pad_idx)
        return torch.fft.fft(x.to(self.complex))

    @staticmethod
    def _fold(spec: torch.Tensor, k: int) -> torch.Tensor:
        """Period-average the spectrum into N / 2^k bins (decimate by 2^k)."""
        if k == 0:
            return spec
        n = spec.shape[-1]
        return spec.reshape(spec.shape[:-1] + (2 ** k, n // 2 ** k)).mean(-2)

    def scattering(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, 1 + C1, n_out): the phi low-pass of the signal, then of each
        first-order band's modulus, on the output grid."""
        fb, k0 = self.fb, self.k0
        s0 = torch.fft.ifft(self._fold(spec * self.phi[0], k0)).real
        out = [s0[:, None, fb.ind_start[k0]:fb.ind_end[k0]]]
        for n1 in range(fb.psi1.shape[0]):
            k1 = int(self.k1[n1])
            u1 = torch.fft.ifft(self._fold(spec * self.psi1[n1], k1)).abs()
            out.append(self.pol.mm(u1, self.lowpass[k1])[:, None])
        return torch.cat(out, dim=1)

    def correlations(self, spec_i: torch.Tensor, spec_j: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(phase (B, 44, n_out), cross (B, 130, n_out)) in subset order."""
        spec = torch.cat([spec_i, spec_j], dim=-1)
        out = [None, None]
        sizes = (len(self.phase), len(self.cross))
        for g in self.groups:
            z = torch.fft.ifft(spec[..., g["idx"]] * g["win"])
            ph = torch.angle(z) + g["ramp"]
            ph = torch.where(ph > math.pi, ph - 2 * math.pi, ph)
            phs = ph[:, g["ip"]] * g["powers"] - g["ramp"][g["jp"]]
            a = z.abs()[:, g["ip"]]
            ar, ai = a * torch.cos(phs), a * torch.sin(phs)
            zj = z[:, g["jp"]]
            cr = ar * zj.real + ai * zj.imag
            ci = ai * zj.real - ar * zj.imag
            dec = self.pol.mm(cr, g["Mr"]) - self.pol.mm(ci, g["Mi"])
            for fam in (0, 1):
                rows = np.where(g["family"] == fam)[0]
                if len(rows) == 0:
                    continue
                if out[fam] is None:
                    out[fam] = dec.new_zeros((dec.shape[0], sizes[fam],
                                              dec.shape[-1]))
                out[fam][:, torch.as_tensor(g["pos"][rows])] = \
                    dec[:, torch.as_tensor(rows, device=dec.device)]
        return out[0], out[1]

    @torch.no_grad()
    def __call__(self, fhr: torch.Tensor, up: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        spec_f = self._spectrum(fhr.to(self.device))
        spec_u = self._spectrum(up.to(self.device))
        st = self.scattering(spec_f)
        ph, cr = self.correlations(spec_f, spec_u)
        sl = slice(self.trim, st.shape[-1] - self.trim)
        return tuple(x[:, :, sl].transpose(1, 2) for x in (st, ph, cr))
