"""Evaluation analyses: transfer entropy, reconstruction quality, causality.

Port of `vae_teb_tpu.eval.analyses.ModelEvaluator`:

  reconstruction_analysis   per-sample VAF / MSE / SNR / mean TE
  analyze_sample            forward outputs and the (B, S, D) TE map
  latent_interpolation      decodes along a line between two latents
  te_shift_analysis         TE vs circular UP shift
  up_gain_sweep             TE vs UP gain
  up_ablation               TE / VAF with and without the UP input

The transfer entropy is KL(posterior || prior) of the model's latent
(`SeqVaeTeb.measure_transfer_entropy`). The shift and gain analyses
recompute the cross-phase coefficients from the raw traces: for a batch of
samples, every (sample x variant) row of shifted or scaled UP goes through
the frontend at once (channel 0 FHR, channel 1 UP), is normalized with the
training statistics, trimmed, and encoded. Everything runs on the
evaluator's device, the model in eval mode, under inference mode; only
the per-sample results come back to the host as numpy arrays.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..data.normalize import FieldStats, normalize_field
from ..device import resolve_device
from ..models.vae_teb import gaussian_kld
from ..ops import PhaseScattering1D
from .metrics import interpolate_latent, reconstruction_metrics

SHIFT_SECONDS_DEFAULT = tuple(range(-60, 1))  # -60 s .. 0 s in 1 s steps
GAINS_DEFAULT = (0.0, 0.5, 1.0, 1.5, 2.0)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


class ModelEvaluator:
    """A SeqVaeTeb with its weights, the scattering frontend and the
    normalization statistics, for the analysis suite.

    The model moves to `device` (default: the CUDA card; without one this
    raises) and is put in eval mode; a `scattering` frontend must live on
    the same device (`PhaseScattering1D(..., device=)`). `stats` ({field:
    FieldStats}) needs "fhr_up_ph" for the shift and gain analyses;
    `cross_subset` selects the cross pairs (the frontend's optimal
    selection in production);
    `trim_decimated` steps are cut from each end of the recomputed
    coefficients. Inputs may be numpy arrays or tensors on any device.
    """

    def __init__(self, model, scattering: Optional[PhaseScattering1D] = None,
                 stats: Optional[Dict[str, FieldStats]] = None,
                 cross_subset: Optional[Sequence[int]] = None,
                 trim_decimated: int = 30, sample_rate_hz: float = 4.0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.scattering = scattering
        self.stats = stats
        self.cross_subset = (tuple(int(i) for i in cross_subset)
                             if cross_subset is not None else None)
        self.trim = trim_decimated
        self.sample_rate_hz = sample_rate_hz

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _fields(self, batch):
        return tuple(self._t(batch[k]) for k in ("fhr_st", "fhr_ph",
                                                 "fhr_up_ph", "fhr"))

    def _metrics(self, y_st, y_ph, x_ph, y_raw) -> Dict[str, torch.Tensor]:
        """Deterministic forward -> per-sample vaf, mse, snr_db and kld
        (the TE averaged over steps and latent dims)."""
        out = self.model(y_st, y_ph, x_ph, deterministic=True)
        m = reconstruction_metrics(y_raw, out["mu_pr"])
        m["kld"] = gaussian_kld(out["mu_prior"], out["logvar_prior"],
                                out["mu_post"], out["logvar_post"],
                                reduce_mean=False).mean(dim=(1, 2))
        return m

    # -- reconstruction + metric histograms ---------------------------------

    @torch.inference_mode()
    def reconstruction_analysis(self, batches: Iterable,
                                pickle_path: Optional[str] = None
                                ) -> Dict[str, np.ndarray]:
        """Per-sample VAF / MSE / SNR / mean TE over batches of normalized,
        trimmed windows (fhr_st, fhr_ph, fhr_up_ph, fhr); optionally
        pickled."""
        acc: Dict[str, list] = {"vaf": [], "mse": [], "snr_db": [], "kld": []}
        for batch in batches:
            m = self._metrics(*self._fields(batch))
            for k in acc:
                acc[k].append(_host(m[k]))
        out = {k: np.concatenate(v) if v else np.zeros(0)
               for k, v in acc.items()}
        if pickle_path:
            with open(pickle_path, "wb") as f:
                pickle.dump(out, f)
        return out

    @torch.inference_mode()
    def analyze_sample(self, y_st, y_ph, x_ph) -> Dict[str, np.ndarray]:
        """Deterministic forward of a batch (often of one) and its per-step,
        per-dim TE map (B, S, D)."""
        y_st, y_ph, x_ph = self._t(y_st), self._t(y_ph), self._t(x_ph)
        out = self.model(y_st, y_ph, x_ph, deterministic=True)
        te_map = gaussian_kld(out["mu_prior"], out["logvar_prior"],
                              out["mu_post"], out["logvar_post"],
                              reduce_mean=False)
        return {"outputs": {k: _host(v) for k, v in out.items()},
                "te_map": _host(te_map)}

    @torch.inference_mode()
    def latent_interpolation(self, sample_a: Dict, sample_b: Dict,
                             steps: int = 8,
                             plot_prefix: Optional[str] = None,
                             animate_path: Optional[str] = None) -> Dict:
        """Posterior-mean latents of two samples (S, C) fields each, a
        linear path of `steps` latents between them, and the decoder's
        reconstruction along it, decoded as one batch. Optionally the
        heatmap grids and a GIF."""
        def _z(s):
            out = self.model(self._t(s["fhr_st"])[None],
                             self._t(s["fhr_ph"])[None],
                             self._t(s["fhr_up_ph"])[None],
                             deterministic=True)
            return _host(out["z"][0])                       # (S, D)

        zs = interpolate_latent(_z(sample_a), _z(sample_b), steps)
        lin, mu_pr, logvar_pr = self.model.decode(self._t(zs))
        result = {"z_path": zs,
                  "linear_output": _host(lin),              # (K, S, C)
                  "raw_mu": _host(mu_pr),
                  "raw_logvar": _host(logvar_pr)}
        z_maps = zs.transpose(0, 2, 1)                      # (K, D, S)
        y_maps = result["linear_output"].transpose(0, 2, 1)  # (K, C, S)
        len_signal = result["raw_mu"].shape[-1]
        if plot_prefix is not None:
            from .plots import plot_latent_interpolation
            plot_latent_interpolation(z_maps, y_maps, plot_prefix,
                                      len_signal=len_signal,
                                      sample_rate_hz=self.sample_rate_hz)
        if animate_path is not None:
            from .plots import animate_latent_interpolation
            animate_latent_interpolation(z_maps, y_maps, animate_path,
                                         len_signal=len_signal,
                                         sample_rate_hz=self.sample_rate_hz)
        return result

    # -- on-the-fly cross-phase recomputation -------------------------------

    def _require_recompute(self):
        if self.scattering is None or self.stats is None \
                or "fhr_up_ph" not in self.stats:
            raise ValueError("shift/gain analyses need the scattering "
                             "frontend and fhr_up_ph normalization stats")

    def _cross_phase_te(self, fhr_b, up_variants, y_st_b, y_ph_b):
        """(K, N) FHR traces + (K, N) UP variants + (K, S, C) target
        coefficients -> (K,) mean TE, batched over K (samples x
        variants)."""
        trim = self.trim
        x2 = torch.stack([fhr_b, up_variants], dim=1)   # 0 FHR, 1 UP
        coeffs = self.scattering(
            x2, compute_phase=False, compute_cross_phase=True,
            cross_subset=self.cross_subset,
            compute_scattering=False)["cross_phase_corr"]       # (K, C, S)
        coeffs = normalize_field(coeffs, "fhr_up_ph", self.stats["fhr_up_ph"],
                                 channel_axis=-2).transpose(1, 2)
        s_full = coeffs.shape[1]
        coeffs = coeffs[:, trim:s_full - trim]
        # y_st / y_ph may arrive untrimmed, from an untrimmed reader
        if y_st_b.shape[1] == s_full:
            y_st_b = y_st_b[:, trim:s_full - trim]
            y_ph_b = y_ph_b[:, trim:s_full - trim]
        te = self.model.measure_transfer_entropy(y_st_b, y_ph_b, coeffs)
        return te.mean(dim=(1, 2))

    def _variants_te(self, fhr_raw, ups, y_st, y_ph):
        """(M, N) raw FHR + (M, K, N) UP variants -> (M, K) TE, all M x K
        rows in one pass."""
        m, k, n = ups.shape
        rows = lambda x: x[:, None].expand((m, k) + x.shape[1:]).reshape(
            (m * k,) + x.shape[1:])
        te = self._cross_phase_te(rows(fhr_raw), ups.reshape(m * k, n),
                                  rows(y_st), rows(y_ph))
        return te.reshape(m, k)

    def _as_sample_batch(self, fhr_raw, up_raw, y_st, y_ph):
        """Device tensors, a single (N,) / (S, C) sample promoted to a
        batch of one; and whether it was single."""
        fhr_raw, up_raw, y_st, y_ph = (self._t(x) for x in (fhr_raw, up_raw,
                                                             y_st, y_ph))
        single = fhr_raw.ndim == 1
        if single:
            fhr_raw, up_raw = fhr_raw[None], up_raw[None]
            y_st, y_ph = y_st[None], y_ph[None]
        return fhr_raw, up_raw, y_st, y_ph, single

    @torch.inference_mode()
    def te_shift_analysis(self, fhr_raw, up_raw, y_st, y_ph,
                          shift_seconds: Sequence[int] = SHIFT_SECONDS_DEFAULT
                          ) -> Dict[str, np.ndarray]:
        """TE vs circular UP shift. fhr_raw / up_raw are the untrimmed,
        unnormalized raw traces, one sample (N,) or a batch (M, N); y_st /
        y_ph the matching normalized target coefficients, trimmed or not.
        Returns TE of shape (K,) / (M, K) for the K shifts, UP rolled by
        int(s * sample_rate_hz) samples as `torch.roll` rolls."""
        self._require_recompute()
        fhr_raw, up_raw, y_st, y_ph, single = self._as_sample_batch(
            fhr_raw, up_raw, y_st, y_ph)
        n = up_raw.shape[-1]
        shifts = torch.tensor([int(s * self.sample_rate_hz)
                               for s in shift_seconds], device=self.device)
        # roll by s: out[i] = up[(i - s) mod n], every shift in one gather
        idx = (torch.arange(n, device=self.device)[None]
               - shifts[:, None]).remainder(n)                    # (K, N)
        te = self._variants_te(fhr_raw, up_raw[:, idx], y_st, y_ph)
        return {"shift_seconds": np.asarray(shift_seconds),
                "te": _host(te[0] if single else te)}

    @torch.inference_mode()
    def up_gain_sweep(self, fhr_raw, up_raw, y_st, y_ph,
                      gains: Sequence[float] = GAINS_DEFAULT
                      ) -> Dict[str, np.ndarray]:
        """TE vs UP amplitude gain, for one sample (K,) or a batch
        (M, K); inputs as `te_shift_analysis`'s."""
        self._require_recompute()
        fhr_raw, up_raw, y_st, y_ph, single = self._as_sample_batch(
            fhr_raw, up_raw, y_st, y_ph)
        g = torch.tensor(gains, dtype=torch.float32, device=self.device)
        te = self._variants_te(fhr_raw, g[None, :, None] * up_raw[:, None],
                               y_st, y_ph)
        return {"gains": np.asarray(gains),
                "te": _host(te[0] if single else te)}

    # -- ablation -----------------------------------------------------------

    @torch.inference_mode()
    def up_ablation(self, batches: Iterable) -> Dict[str, np.ndarray]:
        """TE and VAF per sample with the real source input and with it
        zeroed."""
        acc: Dict[str, list] = {"te_with_up": [], "te_without_up": [],
                                "vaf_with_up": [], "vaf_without_up": []}
        for batch in batches:
            y_st, y_ph, x_ph, y_raw = self._fields(batch)
            m_with = self._metrics(y_st, y_ph, x_ph, y_raw)
            m_without = self._metrics(y_st, y_ph, torch.zeros_like(x_ph),
                                      y_raw)
            acc["te_with_up"].append(_host(m_with["kld"]))
            acc["te_without_up"].append(_host(m_without["kld"]))
            acc["vaf_with_up"].append(_host(m_with["vaf"]))
            acc["vaf_without_up"].append(_host(m_without["vaf"]))
        return {k: np.concatenate(v) for k, v in acc.items()}
