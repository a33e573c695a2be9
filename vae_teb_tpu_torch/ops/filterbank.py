"""Morlet/Gaussian scattering filter banks, built in the Fourier domain.

Pure NumPy, build-time only: every function here runs once when a transform
is constructed, and its outputs become device constants. A line-for-line
port of `vae_teb_tpu.ops.filterbank` (the JAX package imports JAX from its
`ops` package, so the port carries its own copy); tests/test_torch_frontend.py
holds every array equal to the JAX package's. The math follows kymatio's
scattering1d filter bank (Morlet/Gauss construction, sigma calibration,
dyadic subsampling, padding).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

# Default calibration constants shared by the whole filter-bank family.
R_PSI = math.sqrt(0.5)  # adjacent-filter overlap at the sqrt(1/2)-bandwidth
SIGMA0 = 0.1            # low-pass width at scale 0
ALPHA = 5.0             # anti-aliasing safety factor for dyadic subsampling
P_MAX = 5               # max periods used when periodizing Fourier filters
EPS = 1e-7              # periodization precision
CRITERION_AMPLITUDE = 1e-3  # tail mass allowed outside the temporal support


def periodize_fourier(h: np.ndarray, nperiods: int) -> np.ndarray:
    """Fold a length-(N*nperiods) Fourier response into N bins by averaging
    its periods. Folding in Fourier == discretizing the filter in time."""
    n = h.shape[0] // nperiods
    return h.reshape(nperiods, n).mean(axis=0)


def _adaptive_periods(sigma: float, eps: float = EPS) -> int:
    """Smallest P with |ĝ_sigma(P)| <= eps so the periodized Gaussian is
    continuous on [0, 1)."""
    return int(math.ceil(math.sqrt(-2.0 * sigma * sigma * math.log(eps)) + 1.0))


def _l1_time_norm(h_f: np.ndarray) -> float:
    """1 / ||h||_1 with h the time-domain filter (via inverse FFT)."""
    h_t = np.fft.ifft(h_f)
    total = np.abs(h_t).sum()
    if total < 1e-7:
        raise ValueError("filter has (near-)zero time-domain l1 mass")
    return 1.0 / total


def morlet_fourier(N: int, xi: float, sigma: float,
                   p_max: int = P_MAX, eps: float = EPS) -> np.ndarray:
    """Fourier transform of an l1-normalized Morlet wavelet.

    psi(t) = g_sigma(t) (e^{i xi t} - beta): a Gabor bump at xi minus a
    scaled low-pass so the time-domain mean is exactly zero. Sampled over
    2P-1 periods then folded to N bins.
    """
    P = min(_adaptive_periods(sigma, eps), p_max)
    freqs = np.arange((1 - P) * N, P * N, dtype=np.float64) / float(N)
    if P == 1:
        low_freqs = np.fft.fftfreq(N)
    else:
        low_freqs = freqs
    gabor = np.exp(-((freqs - xi) ** 2) / (2.0 * sigma * sigma))
    lowpass = np.exp(-(low_freqs ** 2) / (2.0 * sigma * sigma))
    gabor = periodize_fourier(gabor, 2 * P - 1)
    lowpass = periodize_fourier(lowpass, 2 * P - 1)
    # Cancel the DC component: morlet(0) == 0.
    kappa = gabor[0] / lowpass[0]
    morlet = gabor - kappa * lowpass
    return morlet * _l1_time_norm(morlet)


def gauss_fourier(N: int, sigma: float,
                  p_max: int = P_MAX, eps: float = EPS) -> np.ndarray:
    """Fourier transform of an l1-normalized Gaussian low-pass."""
    P = min(_adaptive_periods(sigma, eps), p_max)
    if P == 1:
        freqs = np.fft.fftfreq(N)
    else:
        freqs = np.arange((1 - P) * N, P * N, dtype=np.float64) / float(N)
    g = np.exp(-(freqs ** 2) / (2.0 * sigma * sigma))
    g = periodize_fourier(g, 2 * P - 1)
    return g * _l1_time_norm(g)


def sigma_for_xi(xi: float, Q: float, r: float = R_PSI) -> float:
    """Bandwidth so adjacent filters (ratio 2^{1/Q}) intersect at their
    r-bandwidth."""
    factor = 2.0 ** (-1.0 / Q)
    return xi * ((1.0 - factor) / (1.0 + factor)) / math.sqrt(2.0 * math.log(1.0 / r))


def max_dyadic_subsampling(xi: float, sigma: float, alpha: float = ALPHA) -> int:
    """Largest j with xi + alpha*sigma < 2^{-(j+1)}: subsampling by 2^j is
    alias-free for a bump at xi of width sigma."""
    upper = min(xi + alpha * sigma, 0.5)
    return int(math.floor(-math.log2(upper)) - 1)


def xi_max_for_q(Q: float) -> float:
    """Highest usable center frequency for a Q-per-octave family."""
    return max(1.0 / (1.0 + 2.0 ** (3.0 / Q)), 0.35)


def filterbank_params(sigma_min: float, Q: int, r_psi: float = R_PSI,
                      alpha: float = ALPHA) -> Tuple[list, list, list]:
    """Center frequencies, widths, and max-subsampling exponents of one
    wavelet family: geometric 2^{-1/Q} steps down from xi_max while the
    width stays above sigma_min, then Q-1 linearly spaced low-frequency
    filters at constant width sigma_min.
    """
    xi_top = xi_max_for_q(Q)
    sigma_top = sigma_for_xi(xi_top, Q, r=r_psi)

    xis: list = []
    sigmas: list = []
    js: list = []

    if sigma_top <= sigma_min:
        last_xi = sigma_top
    else:
        xi, sigma = xi_top, sigma_top
        while sigma > sigma_min:
            xis.append(xi)
            sigmas.append(sigma)
            js.append(max_dyadic_subsampling(xi, sigma, alpha=alpha))
            step = 2.0 ** (-1.0 / Q)
            xi, sigma = xi * step, sigma * step
        last_xi = xis[-1]

    n_linear = Q - 1
    for q in range(1, n_linear + 1):
        new_xi = last_xi * (n_linear + 1.0 - q) / (n_linear + 1.0)
        xis.append(new_xi)
        sigmas.append(sigma_min)
        js.append(max_dyadic_subsampling(new_xi, sigma_min, alpha=alpha))
    return xis, sigmas, js


def calibrate(J: int, Q: int, T: int, r_psi: float = R_PSI,
              sigma0: float = SIGMA0, alpha: float = ALPHA):
    """Spectral parameters for both wavelet orders plus the low-pass width.

    Order 1 uses Q wavelets/octave, order 2 always 1/octave; both share
    sigma_min = sigma0 / 2^J. The low-pass width is sigma0 / T.
    """
    if Q < 1:
        raise ValueError(f"Q must be >= 1, got {Q}")
    sigma_min = sigma0 / (2.0 ** J)
    xi1, sig1, j1 = filterbank_params(sigma_min, Q, r_psi=r_psi, alpha=alpha)
    xi2, sig2, j2 = filterbank_params(sigma_min, 1, r_psi=r_psi, alpha=alpha)
    sigma_low = sigma0 / T
    return sigma_low, xi1, sig1, j1, xi2, sig2, j2


def temporal_support(h_f: np.ndarray,
                     criterion_amplitude: float = CRITERION_AMPLITUDE) -> int:
    """Half temporal support N such that truncating the (centered,
    symmetric) filter to [-N, N] loses at most criterion_amplitude of
    worst-case convolution error."""
    h = np.fft.ifft(h_f, axis=-1)
    if h.ndim == 1:
        h = h[None, :]
    half = h.shape[-1] // 2
    # Residual l1 tail mass when truncated at each candidate support.
    tail = np.cumsum(np.abs(h)[:, :half][:, ::-1], axis=-1)[:, ::-1]
    worst = tail.max(axis=0)
    ok = np.where(worst <= criterion_amplitude)[0]
    if ok.size:
        return int(ok.min()) + 1
    return half


def min_support_to_pad(N: int, J: int, Q: int, T: int,
                       criterion_amplitude: float = CRITERION_AMPLITUDE) -> int:
    """Minimum one-sided padding to keep boundary error below the
    criterion: three times the low-pass temporal support at the tentative
    dyadic resolution of the input."""
    J_tentative = int(np.ceil(np.log2(N)))
    sigma_low = SIGMA0 / T
    phi = gauss_fourier(2 ** J_tentative, sigma_low)
    return 3 * temporal_support(phi, criterion_amplitude)


def compute_padding(J_pad: int, N: int) -> Tuple[int, int]:
    """Split (2^J_pad - N) into left/right padding (left gets the floor)."""
    if 2 ** J_pad < N:
        raise ValueError("padded size must cover the signal")
    to_add = 2 ** J_pad - N
    pad_left = to_add // 2
    pad_right = to_add - pad_left
    if max(pad_left, pad_right) >= N:
        raise ValueError("padding exceeds signal length; reflect pad would alias")
    return pad_left, pad_right


def border_indices(J: int, i0: int, i1: int) -> Tuple[np.ndarray, np.ndarray]:
    """Start/end indices of the unpadded signal at every dyadic scale
    0..J: ceil-halved from the finest-resolution [i0, i1)."""
    starts = [i0]
    ends = [i1]
    for _ in range(J):
        starts.append((starts[-1] + 1) // 2)
        ends.append((ends[-1] + 1) // 2)
    return np.asarray(starts), np.asarray(ends)


@dataclass(frozen=True)
class FilterBank:
    """All Fourier-domain filters + geometry for one scattering config.

    Filters are stored stacked (channel-major) so the transform can apply a
    whole order with a single broadcasted complex multiply.

    Attributes
    ----------
    psi1          (C1, N_padded) float64 — first-order Morlets (level 0)
    psi1_xi/sigma/j  (C1,) — center freq / width / max dyadic subsampling
    psi2_levels   list over levels k of (C2, N_padded / 2^k)
    psi2_xi/sigma/j  (C2,)
    phi_levels    list over levels k of (N_padded / 2^k,)
    sigma_low     low-pass width
    log2_T        floor(log2(T)) — total dyadic decimation of the output
    J, Q, T, N, J_pad, N_padded, pad_left, pad_right
    ind_start/ind_end  (J+1,) border indices per scale
    t_max_phi     low-pass half temporal support (pad criterion)
    """

    J: int
    Q: int
    T: int
    N: int
    J_pad: int
    N_padded: int
    pad_left: int
    pad_right: int
    log2_T: int
    sigma_low: float
    t_max_phi: int
    psi1: np.ndarray
    psi1_xi: np.ndarray
    psi1_sigma: np.ndarray
    psi1_j: np.ndarray
    psi2_levels: tuple
    psi2_xi: np.ndarray
    psi2_sigma: np.ndarray
    psi2_j: np.ndarray
    phi_levels: tuple
    ind_start: np.ndarray
    ind_end: np.ndarray

    @property
    def n_order1(self) -> int:
        return self.psi1.shape[0]

    @property
    def n_order2(self) -> int:
        return self.psi2_levels[0].shape[0] if self.psi2_levels else 0


def build_filter_bank(J: int, Q: int, T: int, N: int,
                      r_psi: float = R_PSI, sigma0: float = SIGMA0,
                      alpha: float = ALPHA,
                      criterion_amplitude: float = CRITERION_AMPLITUDE) -> FilterBank:
    """Build the full filter bank for an input of length N.

    Padding policy matches the reference phase-scattering pipeline:
    min_to_pad capped at N-1, J_pad = min(ceil(log2(N + 2*min_to_pad)),
    floor(log2(3N - 2))).
    """
    min_to_pad = min(min_support_to_pad(N, J, Q, T, criterion_amplitude), N - 1)
    J_max_support = int(np.floor(np.log2(3 * N - 2)))
    J_pad = min(int(np.ceil(np.log2(N + 2 * min_to_pad))), J_max_support)
    N_padded = 2 ** J_pad
    pad_left, pad_right = compute_padding(J_pad, N)
    ind_start, ind_end = border_indices(J, pad_left, pad_left + N)

    sigma_low, xi1, sig1, j1, xi2, sig2, j2 = calibrate(
        J, Q, T, r_psi=r_psi, sigma0=sigma0, alpha=alpha)
    log2_T = int(math.floor(math.log2(T)))

    psi1 = np.stack([morlet_fourier(N_padded, x, s) for x, s in zip(xi1, sig1)])

    # Levels 0..log2_T cover every subsampling the averaged cascade needs
    # (order-2 filters consume inputs decimated by 2^{k1} with k1 <= log2_T,
    # and phi smooths at the same set of resolutions).
    psi2_l0 = np.stack([morlet_fourier(N_padded, x, s) for x, s in zip(xi2, sig2)]) \
        if xi2 else np.zeros((0, N_padded))
    psi2_levels = [psi2_l0]
    phi_l0 = gauss_fourier(N_padded, sigma_low)
    phi_levels = [phi_l0]
    for level in range(1, log2_T + 1):
        nper = 2 ** level
        psi2_levels.append(
            np.stack([periodize_fourier(f, nper) for f in psi2_l0])
            if psi2_l0.shape[0] else np.zeros((0, N_padded // nper)))
        phi_levels.append(periodize_fourier(phi_l0, nper))

    t_max_phi = temporal_support(phi_l0[None, :], criterion_amplitude)

    return FilterBank(
        J=J, Q=Q, T=T, N=N, J_pad=J_pad, N_padded=N_padded,
        pad_left=pad_left, pad_right=pad_right, log2_T=log2_T,
        sigma_low=sigma_low, t_max_phi=int(t_max_phi),
        psi1=psi1,
        psi1_xi=np.asarray(xi1), psi1_sigma=np.asarray(sig1),
        psi1_j=np.asarray(j1, dtype=np.int32),
        psi2_levels=tuple(psi2_levels),
        psi2_xi=np.asarray(xi2), psi2_sigma=np.asarray(sig2),
        psi2_j=np.asarray(j2, dtype=np.int32),
        phi_levels=tuple(phi_levels),
        ind_start=ind_start, ind_end=ind_end,
    )


def output_size(J: int, Q: int, T: int, max_order: int = 2) -> Tuple[int, ...]:
    """(n_order0, n_order1[, n_order2]) coefficient counts."""
    _, xi1, _, j1, xi2, _, j2 = calibrate(J, Q, T)
    n1 = len(xi1)
    n2 = sum(1 for a in j1 for b in j2 if b > a)
    if max_order == 1:
        return (1, n1)
    return (1, n1, n2)
