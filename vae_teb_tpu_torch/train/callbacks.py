"""Training-time callbacks for `Trainer.fit`.

Port of `vae_teb_tpu.train.callbacks`: `Callback`, `HistoryCallback` and
`MemoryMonitorCallback`. Hooks are on_epoch_end(trainer, epoch) and
on_fit_end(trainer): the trainer holds the state the JAX package passes
as a separate argument. `LossCurveCallback` and
`ReconstructionPlotCallback` need matplotlib and the evaluation plots, and
go with the eval slice.
"""

from __future__ import annotations

import os
import pickle

import torch


class Callback:
    """Base hook protocol for Trainer.fit."""

    def on_epoch_end(self, trainer, epoch: int) -> None:
        pass

    def on_fit_end(self, trainer) -> None:
        pass


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
