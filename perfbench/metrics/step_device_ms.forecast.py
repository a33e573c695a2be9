"""step_device_ms.forecast: device milliseconds a step of the forecaster's
training: CUDA events around each group of K replayed steps, the mean over
the window's groups, over K.

Layer: Training step (`Trainer.train_multi_step`, `StepGraph.replay`). Moves `train_windows_per_s`. Reads the harness's readings of a
`--trace 1` run of `drivers/train_forecast.py`; returns None where it
finds nothing to read."""


def read(r):
    ms = r.get("group_ms") or []
    if r.get("kind") != "train" or "grid_least_s" not in r or not ms:
        return None
    return sum(ms) / len(ms) / r["K"]
