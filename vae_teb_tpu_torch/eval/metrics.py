"""Scientific metrics: VAF / MSE / SNR, mutual information, log-likelihood.

Port of `vae_teb_tpu.eval.metrics`, with the same definitions.
`reconstruction_metrics` runs on tensors, on whatever device they lie; the
mutual-information estimators and the other helpers are host numpy, as in
the JAX package. sklearn is imported inside the functions that use it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def reconstruction_metrics(original: torch.Tensor, reconstructed: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """Per-sample VAF / MSE / SNR over the last axis. (B, T) -> (B,) each,
    in float32.

    VAF = clip(1 - var(residual)/var(original), 0, 1)
    SNR = 10 log10(mean(x^2) / mean(residual^2)), capped at 100 dB.
    """
    original = original.to(torch.float32)
    residual = original - reconstructed.to(torch.float32)
    var_res = residual.var(dim=-1, correction=0)
    var_orig = original.var(dim=-1, correction=0)
    vaf = torch.where(var_orig > 1e-12,
                      torch.clamp(1.0 - var_res / var_orig.clamp_min(1e-12),
                                  0.0, 1.0),
                      torch.zeros_like(var_orig))
    noise_power = (residual ** 2).mean(dim=-1)
    signal_power = (original ** 2).mean(dim=-1)
    snr = torch.where(noise_power > 1e-12,
                      10.0 * torch.log10(signal_power
                                         / noise_power.clamp_min(1e-12)),
                      torch.full_like(noise_power, 100.0))
    return {"vaf": vaf, "mse": noise_power, "snr_db": snr}


def calculate_vaf(y: np.ndarray, y_hat: np.ndarray) -> float:
    """Scalar VAF in percent."""
    y, y_hat = np.asarray(y), np.asarray(y_hat)
    return float((1.0 - np.var(y - y_hat) / np.var(y)) * 100.0)


def gaussian_log_likelihood(x: np.ndarray, mu: np.ndarray,
                            logvar: np.ndarray) -> float:
    """Mean Gaussian log-likelihood of x under N(mu, e^logvar)."""
    var = np.exp(logvar)
    ll = -0.5 * (np.log(2 * math.pi) + logvar + (x - mu) ** 2 / var)
    return float(np.mean(ll))


def interpolate_latent(z1: np.ndarray, z2: np.ndarray,
                       n_steps: int = 10) -> np.ndarray:
    """Linear interpolation path (n_steps, ...) between two latents."""
    alphas = np.linspace(0.0, 1.0, n_steps)[:, None, None]
    return (1 - alphas) * z1[None] + alphas * z2[None]


def gaussian_mutual_information(X: np.ndarray, Y: np.ndarray,
                                reduce_dim: bool = False,
                                n_components_X: int = 50,
                                n_components_Y: int = 25) -> float:
    """Gaussian MI estimate via covariance log-determinants, optionally
    after PCA.

    X: (N, T, Cx), Y: (N, T, Cy) -> 0.5 (logdet Sx + logdet Sy - logdet Sxy)
    """
    X, Y = np.asarray(X), np.asarray(Y)
    n = X.shape[0]
    X_flat = X.reshape(n, -1)
    Y_flat = Y.reshape(n, -1)
    if reduce_dim:
        from sklearn.decomposition import PCA
        X_flat = PCA(n_components=n_components_X,
                     svd_solver="full").fit_transform(X_flat)
        Y_flat = PCA(n_components=n_components_Y,
                     svd_solver="full").fit_transform(Y_flat)
    XY = np.hstack([X_flat, Y_flat])
    eps = 1e-10

    def logdet(a):
        cov = np.cov(a, rowvar=False)
        cov = np.atleast_2d(cov) + eps * np.eye(a.shape[1])
        sign, val = np.linalg.slogdet(cov)
        if sign <= 0:
            raise ValueError("covariance matrix is not positive definite")
        return val

    return 0.5 * (logdet(X_flat) + logdet(Y_flat) - logdet(XY))


def discretize_signal(signal: np.ndarray, bins: int = 10) -> np.ndarray:
    """Bin a continuous signal into `bins` equal-width bins."""
    edges = np.linspace(np.min(signal), np.max(signal), bins)
    return np.digitize(signal, bins=edges)


def histogram_mutual_information(X: np.ndarray, Z: np.ndarray,
                                 bins: int = 10) -> np.ndarray:
    """Channel-pairwise histogram MI matrix (Cx, Cz) of X (N, T, Cx) and
    Z (N, T, Cz)."""
    from sklearn.metrics import mutual_info_score
    cx, cz = X.shape[2], Z.shape[2]
    x_disc = [discretize_signal(X[:, :, i].ravel(), bins) for i in range(cx)]
    z_disc = [discretize_signal(Z[:, :, j].ravel(), bins) for j in range(cz)]
    mi = np.zeros((cx, cz))
    for i in range(cx):
        for j in range(cz):
            mi[i, j] = mutual_info_score(x_disc[i], z_disc[j])
    return mi
