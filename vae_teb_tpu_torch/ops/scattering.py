"""Averaged 1-D wavelet scattering transform (orders 0, 1 and 2) in PyTorch.

Port of `vae_teb_tpu.ops.scattering`. The JAX package carries complex
spectra as split (re, im) float pairs and runs its DFTs as matmuls; here
spectra are complex64 tensors and the transforms are `torch.fft` calls.
The filter bank, the grouping of filters by their dyadic subsampling
factors (first order by k1, second order by (k1, k2)), and the dense
second-stage low-pass operators are the same NumPy builds.

Numerical semantics (kymatio's scattering1d torch backend):
  - pad: reflect, chained for pads longer than the signal
  - subsample_fourier(k): mean over the k Fourier periods
  - modulus: |z|
  - FFTs: full length, 'backward' norm
  - unpad: slice [ind_start, ind_end)
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
    """Averaged 1-D scattering transform.

    Construction builds the NumPy filter bank and moves its constants to
    `device`; calling the instance returns a channel-stacked
    (..., 1 + C1 [+ C2], N_out) float32 tensor ordered
    [order0, order1..., order2...], as the JAX package's.
    """

    def __init__(self, J: int, Q: int, T: int, shape: int, max_order: int = 2,
                 oversampling: int = 0,
                 filter_bank: Optional[FilterBank] = None,
                 device: Optional[torch.device] = None):
        self.J, self.Q, self.T, self.N = J, Q, T, int(shape)
        self.max_order = max_order
        self.oversampling = oversampling
        fb = filter_bank or build_filter_bank(J, Q, T, self.N)
        self.fb = fb
        self.log2_T = log2_T = fb.log2_T
        self.k0 = max(log2_T - oversampling, 0)
        self.n_out = int(fb.ind_end[self.k0] - fb.ind_start[self.k0])
        self.pad_left, self.pad_right = fb.pad_left, fb.pad_right
        self.ind_start, self.ind_end = fb.ind_start, fb.ind_end
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)

        # group first-order filters by their subsampling factor k1, so every
        # group's band signals share one static length
        k1_all = np.maximum(
            np.minimum(fb.psi1_j - oversampling, log2_T - oversampling), 0)
        groups1 = [(k1, np.where(k1_all == k1)[0])
                   for k1 in sorted(set(int(k) for k in k1_all))]
        self._groups1 = [(k1, t(rows)) for k1, rows in groups1]
        self._order1_perm = t(np.argsort(
            np.concatenate([rows for _, rows in groups1])))

        # second-order pairs (n1, n2) with j2 > j1, in output order (n1-major),
        # grouped by (k1, k2); each group gathers its rows of |U1|'s
        # spectrum within the k1 group and its psi2 filters at level k1
        self._groups2 = []   # (k1, k2, output rows, rows within k1 group, psi2)
        self._n2_pairs = 0
        if max_order >= 2:
            bykey = {}
            for n1, j1 in enumerate(fb.psi1_j):
                k1 = int(k1_all[n1])
                for n2, j2 in enumerate(fb.psi2_j):
                    if j2 > j1:
                        k2 = max(min(int(j2) - k1 - oversampling,
                                     log2_T - k1 - oversampling), 0)
                        bykey.setdefault((k1, k2), []).append(
                            (self._n2_pairs, n1, n2))
                        self._n2_pairs += 1
            rows1 = dict(groups1)
            for (k1, k2), items in sorted(bykey.items()):
                idxs, n1s, n2s = (np.array(c) for c in zip(*items))
                pos = np.searchsorted(rows1[k1], n1s)
                self._groups2.append(
                    (k1, k2, t(idxs), t(pos),
                     t(fb.psi2_levels[k1][n2s], torch.float32)))

        self.psi1_f = t(fb.psi1, torch.float32)
        self.phi0_f = t(fb.phi_levels[0], torch.float32)
        # second stage per input resolution k_in (every k1 and k1 + k2):
        # modulus time signal -> smoothed, decimated, unpadded output, as
        # one dense operator
        k_ins = set(k1 for k1, _ in groups1)
        k_ins.update(k1 + k2 for k1, k2, *_ in self._groups2)
        self._lp_time_ops = {}
        for k_in in sorted(k_ins):
            k_j = max(log2_T - k_in - oversampling, 0)
            k_tot = k_in + k_j
            op = _build_lowpass_time_operator(
                fb.phi_levels[k_in], k_j,
                int(fb.ind_start[k_tot]), int(fb.ind_end[k_tot]))
            self._lp_time_ops[k_in] = t(op)

    @property
    def output_channels(self) -> int:
        return 1 + self.fb.n_order1 + self._n2_pairs

    def meta(self):
        """Coefficient metadata per output channel (order, center frequency,
        width, dyadic scale, filter indices), NaN-padded to max_order
        entries, as the JAX package's `meta`."""
        fb = self.fb
        order, xi, sigma, j, n = [0], [()], [()], [()], [()]
        for n1 in range(fb.n_order1):
            order.append(1)
            xi.append((float(fb.psi1_xi[n1]),))
            sigma.append((float(fb.psi1_sigma[n1]),))
            j.append((int(fb.psi1_j[n1]),))
            n.append((n1,))
        if self.max_order >= 2:
            for n1 in range(fb.n_order1):
                for n2 in range(len(fb.psi2_j)):
                    if fb.psi2_j[n2] > fb.psi1_j[n1]:
                        order.append(2)
                        xi.append((float(fb.psi1_xi[n1]),
                                   float(fb.psi2_xi[n2])))
                        sigma.append((float(fb.psi1_sigma[n1]),
                                      float(fb.psi2_sigma[n2])))
                        j.append((int(fb.psi1_j[n1]), int(fb.psi2_j[n2])))
                        n.append((n1, n2))

        def padded(rows):
            return np.array([r + (math.nan,) * (self.max_order - len(r))
                             for r in rows])

        return {"order": np.array(order), "xi": padded(xi),
                "sigma": padded(sigma), "j": padded(j), "n": padded(n),
                "key": list(n)}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., N) real -> (..., 1 + C1 [+ C2], N_out)."""
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
        s1, u1_specs = [], {}
        for k1, rows in self._groups1:
            bands = subsample_fourier(spec[:, None, :] * self.psi1_f[rows],
                                      2 ** k1)
            u1 = torch.fft.ifft(bands).abs()
            if self._groups2:
                u1_specs[k1] = torch.fft.fft(u1)   # order 2 reads |U1|'s spectrum
            s1.append(u1 @ self._lp_time_ops[k1])
        outs = [s0, torch.cat(s1, dim=1)[:, self._order1_perm, :]]
        if self._groups2:
            s2 = spec.real.new_empty((spec.shape[0], self._n2_pairs,
                                      self.n_out))
            for k1, k2, idxs, pos, psi2 in self._groups2:
                bands = subsample_fourier(u1_specs[k1][:, pos, :] * psi2,
                                          2 ** k2)
                u2 = torch.fft.ifft(bands).abs()
                s2[:, idxs, :] = u2 @ self._lp_time_ops[k1 + k2]
            outs.append(s2)
        return torch.cat(outs, dim=1)

    def _lowpass_order0(self, spec: torch.Tensor) -> torch.Tensor:
        """Smooth the full-rate spectrum with phi, decimate by 2^k0, and
        unpad. The smoothed spectrum is Hermitian, so the real part of its
        inverse is the whole signal."""
        k = self.k0
        s = torch.fft.ifft(subsample_fourier(spec * self.phi0_f, 2 ** k)).real
        return s[..., int(self.ind_start[k]):int(self.ind_end[k])]
