"""The full evaluation battery, `cli test`'s body.

Port of `vae_teb_tpu.eval.suite.run_evaluation_suite`: seeded sample
preselection, metric histograms, per-sample analysis plots, the UP
ablation, TE vs UP shift, the UP gain sweep and the coefficient-domain
acceptance battery, writing figures, pickles and .npy files into an output
directory under the JAX package's names. The figures need matplotlib:
without it the suite raises at the first one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import plots
from .analyses import GAINS_DEFAULT, SHIFT_SECONDS_DEFAULT, ModelEvaluator
from .predict_st import seqvae_mse_test


def run_evaluation_suite(evaluator: ModelEvaluator, dataset, out_dir: str,
                         raw_dataset=None,
                         num_samples: int = 50,
                         batch_size: int = 4,
                         shift_samples: int = 50,
                         shift_seconds: Sequence[int] = SHIFT_SECONDS_DEFAULT,
                         gains: Sequence[float] = GAINS_DEFAULT,
                         seed: int = 0,
                         run_shift_analysis: bool = True,
                         run_gain_sweep: bool = True,
                         plot_samples: Optional[int] = None,
                         recompute_chunk: int = 4) -> Dict:
    """Run every analysis and write artifacts under out_dir.

    `dataset` (trimmed and normalized windows) drives the metrics, the
    ablation, the plots and the coefficient battery; `raw_dataset`
    (untrimmed, with normalized coefficient fields but raw fhr and up)
    drives the shift and gain analyses, which recompute the cross-phase
    coefficients from the raw traces and trim them. Either reader is a
    `CombinedHDF5Dataset` or a `PackedWindowStore`: the suite reads through
    `read_batch` only.

    `num_samples` samples are drawn without replacement from
    `default_rng(seed)`; the first `shift_samples` of them go through the
    recompute analyses, `recompute_chunk` samples (times every shift or
    gain) at a time, which bounds the device memory. `plot_samples=None`
    plots every selected sample. A failing per-sample stage is recorded in
    results["errors"] and the run goes on; a device fault (a CUDA error,
    out of memory) ends it.
    """
    os.makedirs(out_dir, exist_ok=True)
    results: Dict = {}
    errors: list = []

    def _guarded(stage: str, key, fn):
        try:
            return fn()
        except (torch.AcceleratorError, torch.OutOfMemoryError):
            raise   # a device fault is not the sample's: every later one fails
        except Exception as e:  # per-sample isolation
            errors.append({"stage": stage, "sample": key, "error": repr(e)})
            return None

    # 1) seeded preselection
    rng = np.random.default_rng(seed)
    n = min(num_samples, len(dataset))
    sample_ids = rng.choice(len(dataset), size=n, replace=False)
    results["selected_indices"] = sample_ids

    def batches():
        for start in range(0, n, batch_size):
            yield dataset.read_batch(sample_ids[start:start + batch_size])

    # 2) metrics histograms + pickle
    metrics = evaluator.reconstruction_analysis(
        batches(), pickle_path=os.path.join(out_dir, "metrics.pkl"))
    plots.plot_metrics_histograms(
        metrics, os.path.join(out_dir, "metrics_histograms.png"))
    results["metrics"] = metrics

    # 3) per-sample analysis plots
    def _analysis_plots(k: int):
        s = dataset.read_batch([k])                     # a batch of one
        analysis = evaluator.analyze_sample(s["fhr_st"], s["fhr_ph"],
                                            s["fhr_up_ph"])
        out = analysis["outputs"]
        guid = str(s["guid"][0] if "guid" in s else k).replace("/", "_")
        fhr = np.asarray(s["fhr"][0])
        plots.plot_model_analysis(
            fhr, out["mu_pr"][0], analysis["te_map"][0], out["z"][0],
            os.path.join(out_dir, f"analysis_{guid}_{k}.png"),
            title=f"guid={guid}")
        plots.plot_vae_reconstruction(
            fhr, out["mu_pr"][0], out["logvar_pr"][0],
            os.path.join(out_dir, f"reconstruction_{guid}_{k}.png"),
            title=f"guid={guid}")

    n_plot = n if plot_samples is None else min(plot_samples, n)
    for k in sample_ids[:n_plot]:
        _guarded("analysis_plot", int(k), lambda k=int(k): _analysis_plots(k))

    # 4) UP ablation
    ablation = evaluator.up_ablation(batches())
    plots.plot_te_ablation_results(
        ablation, os.path.join(out_dir, "up_ablation.png"))
    results["ablation"] = ablation

    # 5/6) TE vs shift and the UP gain sweep over the preselected samples,
    # chunk by chunk
    recompute = evaluator.scattering is not None and raw_dataset is not None
    if recompute:
        n_raw = len(raw_dataset)
        rc_ids = [int(k) for k in sample_ids[:shift_samples]
                  if int(k) < n_raw]
        chunks = [rc_ids[s:s + recompute_chunk]
                  for s in range(0, len(rc_ids), recompute_chunk)]

    if run_shift_analysis and recompute:
        shift_te, shift_ids = [], []
        for chunk in chunks:
            def _chunk_shift(chunk=chunk):
                b = raw_dataset.read_batch(chunk)
                return evaluator.te_shift_analysis(
                    b["fhr"], b["up"], b["fhr_st"], b["fhr_ph"],
                    shift_seconds=shift_seconds)["te"]        # (M, K)
            te = _guarded("te_shift", chunk, _chunk_shift)
            if te is not None:
                shift_te.append(te)
                shift_ids.extend(chunk)
        if shift_te:
            te_all = np.concatenate(shift_te, axis=0)
            for row, k in zip(te_all[:n_plot], shift_ids):
                plots.plot_transfer_entropy_vs_shift(
                    np.asarray(shift_seconds), row,
                    os.path.join(out_dir, f"te_shift_{k}.png"),
                    title=f"sample {k}")
            results["te_shift"] = {
                "shift_seconds": np.asarray(shift_seconds),
                "sample_indices": np.asarray(shift_ids),
                "te": te_all}

    if run_gain_sweep and recompute:
        gain_te, gain_ids = [], []
        for chunk in chunks:
            def _chunk_gain(chunk=chunk):
                b = raw_dataset.read_batch(chunk)
                return evaluator.up_gain_sweep(
                    b["fhr"], b["up"], b["fhr_st"], b["fhr_ph"],
                    gains=gains)["te"]                        # (M, K)
            te = _guarded("gain_sweep", chunk, _chunk_gain)
            if te is not None:
                gain_te.append(te)
                gain_ids.extend(chunk)
        if gain_te:
            te_all = np.concatenate(gain_te, axis=0)
            plots.plot_te_gain_sweep(
                np.asarray(gains), te_all,
                os.path.join(out_dir, "te_gain_sweep.png"))
            results["gain_sweep"] = {"gains": np.asarray(gains),
                                     "sample_indices": np.asarray(gain_ids),
                                     "te": te_all}

    # 7) coefficient-domain acceptance battery: the decoder's linear_output
    # on the same preselected samples
    stats = _guarded("coefficient_acceptance", None, lambda: seqvae_mse_test(
        evaluator.model, batches(), out_dir=out_dir,
        tag="coefficient_error_stats"))
    if stats is not None:
        results["coefficient_acceptance"] = stats

    results["errors"] = errors
    return results
