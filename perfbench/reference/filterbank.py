"""First-order Morlet/Gaussian scattering filter bank, built in the Fourier
domain in float64 (kymatio's scattering1d construction).

A frozen copy of the NumPy builders that the measured frontend uses, cut
to what a first-order transform needs (no second-order filters). The
benchmark's reference builds its own operators from these, so that a
change to the program's builders cannot move the yardstick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

R_PSI = math.sqrt(0.5)
SIGMA0 = 0.1
ALPHA = 5.0
P_MAX = 5
EPS = 1e-7
CRITERION_AMPLITUDE = 1e-3


def periodize_fourier(h: np.ndarray, nperiods: int) -> np.ndarray:
    n = h.shape[0] // nperiods
    return h.reshape(nperiods, n).mean(axis=0)


def _adaptive_periods(sigma: float, eps: float = EPS) -> int:
    return int(math.ceil(math.sqrt(-2.0 * sigma * sigma * math.log(eps)) + 1.0))


def _l1_time_norm(h_f: np.ndarray) -> float:
    return 1.0 / np.abs(np.fft.ifft(h_f)).sum()


def morlet_fourier(N: int, xi: float, sigma: float) -> np.ndarray:
    """Fourier transform of an l1-normalized Morlet wavelet with zero mean."""
    P = min(_adaptive_periods(sigma), P_MAX)
    freqs = np.arange((1 - P) * N, P * N, dtype=np.float64) / float(N)
    low_freqs = np.fft.fftfreq(N) if P == 1 else freqs
    gabor = periodize_fourier(np.exp(-((freqs - xi) ** 2) / (2.0 * sigma ** 2)),
                              2 * P - 1)
    lowpass = periodize_fourier(np.exp(-(low_freqs ** 2) / (2.0 * sigma ** 2)),
                                2 * P - 1)
    morlet = gabor - (gabor[0] / lowpass[0]) * lowpass
    return morlet * _l1_time_norm(morlet)


def gauss_fourier(N: int, sigma: float) -> np.ndarray:
    """Fourier transform of an l1-normalized Gaussian low-pass."""
    P = min(_adaptive_periods(sigma), P_MAX)
    freqs = (np.fft.fftfreq(N) if P == 1 else
             np.arange((1 - P) * N, P * N, dtype=np.float64) / float(N))
    g = periodize_fourier(np.exp(-(freqs ** 2) / (2.0 * sigma ** 2)), 2 * P - 1)
    return g * _l1_time_norm(g)


def sigma_for_xi(xi: float, Q: float) -> float:
    factor = 2.0 ** (-1.0 / Q)
    return xi * ((1.0 - factor) / (1.0 + factor)) / math.sqrt(
        2.0 * math.log(1.0 / R_PSI))


def max_dyadic_subsampling(xi: float, sigma: float) -> int:
    return int(math.floor(-math.log2(min(xi + ALPHA * sigma, 0.5))) - 1)


def filterbank_params(sigma_min: float, Q: int) -> Tuple[list, list, list]:
    """Centre frequencies, widths and subsampling exponents of one family:
    geometric steps down from xi_max while the width exceeds sigma_min,
    then Q - 1 linearly spaced filters at sigma_min."""
    xi_top = max(1.0 / (1.0 + 2.0 ** (3.0 / Q)), 0.35)
    sigma_top = sigma_for_xi(xi_top, Q)
    xis, sigmas, js = [], [], []
    if sigma_top <= sigma_min:
        last_xi = sigma_top
    else:
        xi, sigma = xi_top, sigma_top
        while sigma > sigma_min:
            xis.append(xi)
            sigmas.append(sigma)
            js.append(max_dyadic_subsampling(xi, sigma))
            step = 2.0 ** (-1.0 / Q)
            xi, sigma = xi * step, sigma * step
        last_xi = xis[-1]
    for q in range(1, Q):
        new_xi = last_xi * (Q - q) / float(Q)
        xis.append(new_xi)
        sigmas.append(sigma_min)
        js.append(max_dyadic_subsampling(new_xi, sigma_min))
    return xis, sigmas, js


def temporal_support(h_f: np.ndarray) -> int:
    h = np.fft.ifft(h_f, axis=-1)
    if h.ndim == 1:
        h = h[None, :]
    half = h.shape[-1] // 2
    tail = np.cumsum(np.abs(h)[:, :half][:, ::-1], axis=-1)[:, ::-1]
    ok = np.where(tail.max(axis=0) <= CRITERION_AMPLITUDE)[0]
    return int(ok.min()) + 1 if ok.size else half


@dataclass(frozen=True)
class FilterBank:
    N: int
    N_padded: int
    pad_left: int
    pad_right: int
    log2_T: int
    psi1: np.ndarray        # (C1, N_padded) float64
    psi1_xi: np.ndarray
    psi1_j: np.ndarray
    phi_levels: tuple       # level k: (N_padded / 2^k,) float64
    ind_start: np.ndarray
    ind_end: np.ndarray


def build_filter_bank(J: int, Q: int, T: int, N: int) -> FilterBank:
    """The first-order filter bank and padding geometry for length-N input."""
    J_tent = int(np.ceil(np.log2(N)))
    min_to_pad = min(3 * temporal_support(gauss_fourier(2 ** J_tent, SIGMA0 / T)),
                     N - 1)
    J_pad = min(int(np.ceil(np.log2(N + 2 * min_to_pad))),
                int(np.floor(np.log2(3 * N - 2))))
    N_padded = 2 ** J_pad
    pad_left = (N_padded - N) // 2
    pad_right = N_padded - N - pad_left
    starts, ends = [pad_left], [pad_left + N]
    for _ in range(J):
        starts.append((starts[-1] + 1) // 2)
        ends.append((ends[-1] + 1) // 2)
    xi1, sig1, j1 = filterbank_params(SIGMA0 / 2.0 ** J, Q)
    log2_T = int(math.floor(math.log2(T)))
    phi0 = gauss_fourier(N_padded, SIGMA0 / T)
    phi_levels = [phi0] + [periodize_fourier(phi0, 2 ** k)
                           for k in range(1, log2_T + 1)]
    return FilterBank(
        N=N, N_padded=N_padded, pad_left=pad_left, pad_right=pad_right,
        log2_T=log2_T,
        psi1=np.stack([morlet_fourier(N_padded, x, s)
                       for x, s in zip(xi1, sig1)]),
        psi1_xi=np.asarray(xi1), psi1_j=np.asarray(j1, dtype=np.int32),
        phi_levels=tuple(phi_levels),
        ind_start=np.asarray(starts), ind_end=np.asarray(ends))


def reflect_pad_indices(n: int, pad_left: int, pad_right: int) -> np.ndarray:
    """Source index of every position of the reflect-padded signal; pads
    longer than n - 1 chain reflections, left side first."""
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
