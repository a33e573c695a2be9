"""grid_roofline.forecast: share of the roofline of the forecaster's
decoder LSTM: the least time of the traced steps' recurrence
(`counts_forecast.grid_least_s`: forward with residuals, and reverse) over
the device time of the operations whose name holds `wavefront_grid` (the
grid kernels, which run the decoder's 3-layer LSTM(256)) in the profiler's
trace of those steps, in %.

Layer: Wavefront kernels (`kernels.wavefront`, `wavefront_*.cu`). Moves `train_windows_per_s`. Reads the harness's readings of a
`--trace 1` run of `drivers/train_forecast.py`; returns None where it
finds nothing to read."""


def read(r):
    tr = r.get("trace") or {}
    spent = sum(s for k, s in tr.get("kernels", {}).items()
                if "wavefront_grid" in k)
    if r.get("kind") != "train" or "grid_least_s" not in r or not spent \
            or not tr.get("units"):
        return None
    return 100.0 * r["grid_least_s"] * tr["units"] / spent
