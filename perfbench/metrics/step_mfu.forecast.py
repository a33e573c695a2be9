"""step_mfu.forecast: the whole forecaster training step's share of the
card's peak: the model's FLOPs of a step (`counts_forecast.step_flops`, 3x
the forward) times the window's steps, over the window's seconds and the
peak of the configuration's precision (float32: 165 TFLOP/s), in %.

Layer: Training step (`Trainer.train_multi_step`, `StepGraph.replay`). Moves `train_windows_per_s`. Reads the harness's readings of a
`--trace 1` run of `drivers/train_forecast.py`; returns None where it
finds nothing to read."""


def read(r):
    if r.get("kind") != "train" or "grid_least_s" not in r or \
            not r["steps"]:
        return None
    return 100.0 * r["flops_per_step"] * r["steps"] / r["window_s"] / \
        r["peak_flops"]
