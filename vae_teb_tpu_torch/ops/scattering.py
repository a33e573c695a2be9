"""Averaged 1-D wavelet scattering transform (orders 0 and 1) in PyTorch.

Port of `vae_teb_tpu.ops.scattering`. The JAX package carries complex
spectra as split (re, im) float pairs and runs its DFTs as matmuls; here
spectra are complex64 tensors and the transforms are `torch.fft` calls.
The filter bank, the grouping of first-order filters by their dyadic
subsampling factor, and the dense second-stage low-pass operators are the
same NumPy builds.

Numerical semantics (kymatio's scattering1d torch backend):
  - pad: reflect, chained for pads longer than the signal
  - subsample_fourier(k): mean over the k Fourier periods
  - modulus: |z|
  - FFTs: full length, 'backward' norm
  - unpad: slice [ind_start, ind_end)

Only first-order scattering without oversampling is ported: the serving
path never computes order 2.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .filterbank import FilterBank, build_filter_bank


def reflect_pad_indices(n: int, pad_left: int, pad_right: int) -> np.ndarray:
    """Source index of every position of the reflect-padded length-n signal
    (no edge duplication). Pads longer than n-1 chain reflections of at
    most len-1 each, left side first, exactly as the JAX `reflect_pad`
    chains its pads; `F.pad(mode="reflect")` refuses such pads."""
    if n <= 1:
        raise ValueError("reflect padding needs at least two samples")
    idx = np.arange(n)
    left, right = pad_left, pad_right
    while left > 0:
        chunk = min(left, len(idx) - 1)
        idx = np.pad(idx, (chunk, 0), mode="reflect")
        left -= chunk
    while right > 0:
        chunk = min(right, len(idx) - 1)
        idx = np.pad(idx, (0, chunk), mode="reflect")
        right -= chunk
    return idx


def reflect_pad(x: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
    """Reflect-pad the last axis (see reflect_pad_indices); a signal of
    length <= 1 is zero-padded, as in the JAX package."""
    n = x.shape[-1]
    if n <= 1:
        return F.pad(x, (pad_left, pad_right))
    idx = torch.as_tensor(reflect_pad_indices(n, pad_left, pad_right),
                          device=x.device)
    return x.index_select(-1, idx)


def _build_lowpass_time_operator(phi: np.ndarray, k_j: int,
                                 i_start: int, i_end: int) -> np.ndarray:
    """Dense (M -> i_end-i_start) operator equal to the second-stage chain
    applied to a REAL time signal u of length M = len(phi):

        out = ifft( subsample_fourier( fft(u) * phi, 2**k_j ) ).real[i_start:i_end]

    The chain is linear, so it folds into one fp32 matrix, composed in
    float64 and applied as one GEMM.
    """
    m = len(phi)
    mf = m >> k_j
    out = np.empty((m, i_end - i_start), np.float32)
    phi64 = np.asarray(phi, np.float64)
    for c0 in range(0, m, 1024):
        c1 = min(c0 + 1024, m)
        block = np.zeros((c1 - c0, m))
        block[np.arange(c1 - c0), np.arange(c0, c1)] = 1.0
        spec = np.fft.fft(block, axis=-1) * phi64
        folded = spec.reshape(c1 - c0, 1 << k_j, mf).mean(axis=1)
        time = np.fft.ifft(folded, axis=-1).real
        out[c0:c1] = time[:, i_start:i_end].astype(np.float32)
    return out


def subsample_fourier(x_hat: torch.Tensor, k: int) -> torch.Tensor:
    """Fold the spectrum into N/k bins by period averaging, which decimates
    the time signal by k."""
    if k == 1:
        return x_hat
    n = x_hat.shape[-1]
    return x_hat.reshape(x_hat.shape[:-1] + (k, n // k)).mean(dim=-2)


def tukey_window(n: int, alpha: Optional[float]) -> np.ndarray:
    """Tukey (tapered-cosine) window with torch.hann_window(periodic=False)'s
    taper convention."""
    if alpha is None or not (0.0 < alpha <= 1.0):
        return np.ones(n)
    if alpha >= 1.0:
        t = np.arange(n)
        return 0.5 * (1.0 - np.cos(2.0 * math.pi * t / (n - 1)))
    taper_len = int(alpha * (n - 1) / 2.0)
    if taper_len == 0:
        return np.ones(n)
    m = 2 * taper_len
    t = np.arange(m)
    taper = 0.5 * (1.0 - np.cos(2.0 * math.pi * t / (m - 1)))
    w = np.ones(n)
    w[:taper_len] = taper[:taper_len]
    w[n - taper_len:] = taper[taper_len:]
    return w


class Scattering1D:
    """Averaged first-order 1-D scattering transform.

    Construction builds the NumPy filter bank and moves its constants to
    `device`; calling the instance returns a channel-stacked
    (..., 1 + C1, N_out) float32 tensor ordered [order0, order1...].
    """

    def __init__(self, J: int, Q: int, T: int, shape: int,
                 filter_bank: Optional[FilterBank] = None,
                 device: Optional[torch.device] = None):
        self.J, self.Q, self.T, self.N = J, Q, T, int(shape)
        fb = filter_bank or build_filter_bank(J, Q, T, self.N)
        self.fb = fb
        self.log2_T = fb.log2_T
        self.n_out = int(fb.ind_end[self.log2_T] - fb.ind_start[self.log2_T])
        self.pad_left, self.pad_right = fb.pad_left, fb.pad_right
        self.ind_start, self.ind_end = fb.ind_start, fb.ind_end

        # group first-order filters by their subsampling factor k1, so every
        # group's band signals share one static length
        k1_all = np.maximum(np.minimum(fb.psi1_j, self.log2_T), 0)
        self._groups1 = []   # (k1, filter-row index tensor)
        rows_all = []
        for k1 in sorted(set(int(k) for k in k1_all)):
            rows = np.where(k1_all == k1)[0]
            rows_all.append(rows)
            self._groups1.append((k1, torch.as_tensor(rows, device=device)))
        self._order1_perm = torch.as_tensor(
            np.argsort(np.concatenate(rows_all)), device=device)

        self.psi1_f = torch.as_tensor(fb.psi1, dtype=torch.float32,
                                      device=device)
        self.phi0_f = torch.as_tensor(fb.phi_levels[0], dtype=torch.float32,
                                      device=device)
        # second stage per band resolution k1: modulus time signal ->
        # smoothed, decimated, unpadded output, as one dense operator
        self._lp_time_ops = {}
        k_tot = self.log2_T
        for k1, _ in self._groups1:
            op = _build_lowpass_time_operator(
                fb.phi_levels[k1], k_tot - k1,
                int(fb.ind_start[k_tot]), int(fb.ind_end[k_tot]))
            self._lp_time_ops[k1] = torch.as_tensor(op, device=device)

    @property
    def output_channels(self) -> int:
        return 1 + self.fb.n_order1

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., N) real -> (..., 1 + C1, N_out)."""
        batch_shape = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1]).to(torch.float32)
        spec = torch.fft.fft(reflect_pad(x, self.pad_left, self.pad_right))
        out = self.scatter_spectrum(spec)
        return out.reshape(batch_shape + out.shape[-2:])

    def scatter_spectrum(self, spec: torch.Tensor) -> torch.Tensor:
        """Scattering from the PADDED input spectrum (B, N_padded) complex64.
        Split out so the phase frontend, which already holds that spectrum,
        does not transform the signal twice."""
        s0 = self._lowpass_order0(spec[:, None, :])
        s1 = []
        for k1, rows in self._groups1:
            bands = subsample_fourier(spec[:, None, :] * self.psi1_f[rows],
                                      2 ** k1)
            u1 = torch.fft.ifft(bands).abs()
            s1.append(u1 @ self._lp_time_ops[k1])
        s1 = torch.cat(s1, dim=1)[:, self._order1_perm, :]
        return torch.cat([s0, s1], dim=1)

    def _lowpass_order0(self, spec: torch.Tensor) -> torch.Tensor:
        """Smooth the full-rate spectrum with phi, decimate by 2^log2_T, and
        unpad. The smoothed spectrum is Hermitian, so the real part of its
        inverse is the whole signal."""
        k = self.log2_T
        s = torch.fft.ifft(subsample_fourier(spec * self.phi0_f, 2 ** k)).real
        return s[..., int(self.ind_start[k]):int(self.ind_end[k])]
