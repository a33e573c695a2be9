"""Coefficient-domain acceptance battery of SeqVaeTeb.

Port of `vae_teb_tpu.eval.predict_st`: `coefficient_error_stats` (per
(sample, channel) MSE, energy-normalized MSE and SNR, per-channel VAF,
per-sample Gaussian log-likelihood over coefficient tracks) and
`seqvae_mse_test`, the decoder's linear_output against the true
[y_st | y_ph] coefficients, and `prediction_accuracy_test`, the chained
future-coefficient windows of `SeqVaeTebPredictSt` against the true
coefficients. Each batch's battery runs on the model's device and only
the (B, C) summaries come back.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def coefficient_error_stats(sx, mu, var=None) -> Dict[str, torch.Tensor]:
    """Metric battery over coefficient tracks.

    sx / mu / var: (B, C, L) true coefficients, predicted mean, predicted
    variance, as tensors (kept on their device) or arrays. Returns float32
    tensors: per-(sample, channel) mse / energy_normalized_mse / snr_db,
    per-channel vaf over the pooled batch (the variance of the residual,
    not of its square), and with `var` the per-sample log_likelihood.
    """
    sx = torch.as_tensor(sx, dtype=torch.float32)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=sx.device)
    err2 = (sx - mu) ** 2
    mse = err2.mean(dim=2)                                    # (B, C)
    energy = (sx ** 2).mean(dim=2)                            # (B, C)
    en_mse = mse / (energy + 1e-12)
    snr_db = 10.0 * torch.log10((energy + 1e-12) / (mse + 1e-12))
    c = sx.shape[1]
    res_var = (sx - mu).transpose(0, 1).reshape(c, -1).var(dim=1,
                                                           correction=0)
    sig_var = sx.transpose(0, 1).reshape(c, -1).var(dim=1, correction=0)
    vaf = 1.0 - res_var / (sig_var + 1e-12)
    out = {"mse": mse, "energy_normalized_mse": en_mse, "snr_db": snr_db,
           "vaf": vaf}
    if var is not None:
        var = torch.as_tensor(var, dtype=torch.float32, device=sx.device)
        ll = (-0.5 * (torch.log(2 * math.pi * (var + 1e-12))
                      + err2 / (var + 1e-12))).mean(dim=(1, 2))
        out["log_likelihood"] = ll                            # (B,)
    return out


def _accumulate(acc: Dict[str, list], stats: Dict) -> None:
    for k, v in stats.items():
        acc.setdefault(k, []).append(
            v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))


def _finalize(acc: Dict[str, list], vaf_key: str = "vaf") -> Dict:
    out = {}
    for k, vs in acc.items():
        if k == vaf_key:  # per-channel, averaged over batches
            out[k] = np.mean(np.stack(vs), axis=0)
        else:
            out[k] = np.concatenate(vs, axis=0)
    return out


def _save_artifacts(results: Dict, out_dir: Optional[str], tag: str) -> None:
    """<tag>-<key>.npy for every result and <tag>-histograms.png (needs
    matplotlib) under out_dir; nothing when out_dir is None."""
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    for k, v in results.items():
        np.save(os.path.join(out_dir, f"{tag}-{k}.npy"), v)
    from .plots import plot_metrics_histograms
    hist = {k: v.mean(axis=-1) if v.ndim > 1 else v
            for k, v in results.items() if k != "vaf"}
    if hist:
        plot_metrics_histograms(
            hist, os.path.join(out_dir, f"{tag}-histograms.png"))


@torch.inference_mode()
def seqvae_mse_test(model, batches: Iterable, trim: int = 20,
                    out_dir: Optional[str] = None,
                    tag: str = "error_stats") -> Dict:
    """Reconstruction accuracy in the COEFFICIENT domain: the model's
    linear_output (B, S, C) against the true [y_st | y_ph] over the
    interior [trim : S - trim], on the model's device in eval mode
    (deterministic forward). Returns numpy arrays: mse, energy-normalized
    mse and snr_db per (sample, channel), vaf per channel (the mean over
    batches); with out_dir, also the .npy files and histograms.
    """
    device = next(model.parameters()).device
    model.eval()
    acc: Dict[str, list] = {}
    for batch in batches:
        y_st, y_ph, x_ph = (torch.as_tensor(batch[k], dtype=torch.float32,
                                            device=device)
                            for k in ("fhr_st", "fhr_ph", "fhr_up_ph"))
        out = model(y_st, y_ph, x_ph, deterministic=True)
        s = y_st.shape[1]
        if s <= 2 * trim:
            raise ValueError(
                f"sequence length {s} too short for trim {trim}: the "
                f"interior slice [{trim}:{s - trim}] would be empty")
        lo, hi = trim, s - trim
        sx = torch.cat([y_st, y_ph], dim=-1).transpose(1, 2)[:, :, lo:hi]
        mu = out["linear_output"].transpose(1, 2)[:, :, lo:hi]
        _accumulate(acc, coefficient_error_stats(sx, mu))
    results = _finalize(acc)
    _save_artifacts(results, out_dir, tag)
    return results


@torch.inference_mode()
def prediction_accuracy_test(model, batches: Iterable,
                             prediction_idx: int = 30,
                             out_dir: Optional[str] = None,
                             tag: str = "prediction_error_stats") -> Dict:
    """Chained future-coefficient prediction accuracy of a
    `SeqVaeTebPredictSt`, on the model's device in eval mode
    (deterministic forward): from prediction_idx on, the H-step window
    predicted at step prediction_idx - 1 + j H covers steps
    prediction_idx + j H .. + H - 1; the num = (S - prediction_idx) // H
    chunks, concatenated, are held against the true coefficients of each
    modality. Returns the battery per modality, keys prefixed scattering_
    / phase_ (vaf per channel, the mean over batches); with out_dir also
    the .npy files and histograms.
    """
    device = next(model.parameters()).device
    model.eval()
    acc: Dict[str, list] = {}
    for batch in batches:
        y_st, y_ph, x_ph = (torch.as_tensor(batch[k], dtype=torch.float32,
                                            device=device)
                            for k in ("fhr_st", "fhr_ph", "fhr_up_ph"))
        out = model(y_st, y_ph, x_ph, deterministic=True)
        h = out["scattering_mu"].shape[2]
        s = y_st.shape[1]
        num = (s - prediction_idx) // h
        if num < 1:
            raise ValueError(
                f"sequence length {s} too short for prediction_idx "
                f"{prediction_idx} with horizon {h}")
        t_idx = torch.as_tensor(prediction_idx - 1 + h * np.arange(num),
                                device=device)
        b = y_st.shape[0]
        for mod, key, target in (("scattering", "scattering", y_st),
                                 ("phase", "phase_harmonic", y_ph)):
            # (B, num, H, C) -> (B, num * H, C) -> (B, C, L)
            mu = out[f"{key}_mu"][:, t_idx].reshape(b, num * h, -1)
            var = torch.exp(out[f"{key}_logvar"][:, t_idx]).reshape(
                b, num * h, -1)
            sx = target[:, prediction_idx:prediction_idx + num * h]
            stats = coefficient_error_stats(sx.transpose(1, 2),
                                            mu.transpose(1, 2),
                                            var.transpose(1, 2))
            _accumulate(acc, {f"{mod}_{k}": v for k, v in stats.items()})
    results = _finalize(acc, vaf_key="__none__")
    # the vaf entries are per channel: the mean over batches
    for k in list(results):
        if k.endswith("_vaf"):
            results[k] = results[k].reshape(len(acc[k]), -1).mean(axis=0)
    _save_artifacts(results, out_dir, tag)
    return results
