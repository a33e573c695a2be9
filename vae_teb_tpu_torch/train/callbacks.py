"""Training-time callbacks for `Trainer.fit`.

Port of `vae_teb_tpu.train.callbacks`: `Callback`, `LossCurveCallback`,
`HistoryCallback`, `MemoryMonitorCallback` and
`ReconstructionPlotCallback`. Hooks are on_epoch_end(trainer, epoch) and
on_fit_end(trainer): the trainer holds the state the JAX package passes
as a separate argument. The two plotting callbacks need matplotlib
(imported by `eval.plots` inside each function); `Trainer.fit` logs a
callback's failure and goes on.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch


class Callback:
    """Base hook protocol for Trainer.fit."""

    def on_epoch_end(self, trainer, epoch: int) -> None:
        pass

    def on_fit_end(self, trainer) -> None:
        pass


class LossCurveCallback(Callback):
    """Rewrite the loss-curve figure every `every` epochs and at the end
    of fit, so a live run has an up-to-date plot."""

    def __init__(self, out_path: str, every: int = 1):
        self.out_path = out_path
        self.every = max(1, every)

    def on_epoch_end(self, trainer, epoch: int) -> None:
        if epoch % self.every:
            return
        from ..eval.plots import plot_loss_curves
        plot_loss_curves(trainer.history, self.out_path)

    def on_fit_end(self, trainer) -> None:
        from ..eval.plots import plot_loss_curves
        plot_loss_curves(trainer.history, self.out_path)


class HistoryCallback(Callback):
    """Pickle trainer.history to `path` after every epoch (written whole,
    then renamed), so an interrupted run keeps its metric trail."""

    def __init__(self, path: str):
        self.path = path

    def _dump(self, trainer) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(trainer.history, f)
        os.replace(tmp, self.path)

    def on_epoch_end(self, trainer, epoch: int) -> None:
        self._dump(trainer)

    def on_fit_end(self, trainer) -> None:
        self._dump(trainer)


class MemoryMonitorCallback(Callback):
    """Per-epoch device-memory watcher on the trainer's CUDA device.

    Records the memory in use and its peak (`torch.cuda.memory_stats`:
    allocated bytes, in MB) into trainer.history["hbm_mb_in_use"] and
    ["hbm_peak_mb"], and warns through log_fn when the memory in use
    exceeds `threshold_fraction` of the card's total
    (`torch.cuda.mem_get_info`). A trainer on another device is skipped
    silently, as the JAX package skips the CPU backend.
    """

    def __init__(self, threshold_fraction: float = 0.9, log_fn=print):
        self.threshold_fraction = threshold_fraction
        self.log_fn = log_fn
        self.peaks_mb: list = []

    def on_epoch_end(self, trainer, epoch: int) -> None:
        device = torch.device(trainer.device)
        if device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        mb = 1024.0 ** 2
        in_use = stats.get("allocated_bytes.all.current", 0) / mb
        peak = stats.get("allocated_bytes.all.peak", 0) / mb
        limit = torch.cuda.mem_get_info(device)[1] / mb
        trainer.history.setdefault("hbm_mb_in_use", []).append(in_use)
        trainer.history.setdefault("hbm_peak_mb", []).append(peak)
        if in_use > self.threshold_fraction * limit:
            self.log_fn(f"memory monitor: {device} at {in_use:.0f}/"
                        f"{limit:.0f} MB (> "
                        f"{100 * self.threshold_fraction:.0f}% threshold) "
                        f"at epoch {epoch}")
        self.peaks_mb.append(peak)


class ReconstructionPlotCallback(Callback):
    """Every `every` epochs, run the trainer's model on one held-out batch
    and write a reconstruction figure per sample.

    batch: fhr_st / fhr_ph / fhr_up_ph / fhr arrays in the model's layout
    (normalized, (B, S, C)). The forward runs on the trainer's device, in
    eval mode and without a gradient, on the first `max_samples` rows; the
    model's mode is restored after it.
    """

    def __init__(self, out_dir: str, batch: Dict[str, np.ndarray],
                 every: int = 10, max_samples: int = 2):
        self.out_dir = out_dir
        self.batch = batch
        self.every = max(1, every)
        self.max_samples = max_samples
        os.makedirs(out_dir, exist_ok=True)

    def on_epoch_end(self, trainer, epoch: int) -> None:
        if epoch % self.every:
            return
        import matplotlib  # noqa: F401  (fail before the forward without it)
        from ..eval.plots import plot_vae_reconstruction
        b = self.batch
        k = min(self.max_samples, len(b["fhr"]))
        model = trainer.model
        training = model.training
        try:
            with torch.inference_mode():
                out = model.eval()(*(torch.as_tensor(
                    b[f][:k], dtype=torch.float32, device=trainer.device)
                    for f in ("fhr_st", "fhr_ph", "fhr_up_ph")),
                    deterministic=True)
                mu = out["mu_pr"].float().cpu().numpy()
                logvar = out["logvar_pr"].float().cpu().numpy()
        finally:
            model.train(training)
        for i in range(k):
            plot_vae_reconstruction(
                np.asarray(b["fhr"][i]), mu[i], logvar[i],
                os.path.join(self.out_dir,
                             f"reconstruction_epoch{epoch:04d}_s{i}.png"),
                title=f"epoch {epoch} sample {i}")
