"""device_idle.forecast: idle share of the card while the forecaster
trains: 1 - the union of the device's operations over the traced stretch
of the window (profiler trace), in %.

Layer: Device (one H100). Moves `train_windows_per_s`. Reads the harness's readings of a
`--trace 1` run of `drivers/train_forecast.py`; returns None where it
finds nothing to read."""


def read(r):
    tr = r.get("trace") or {}
    if r.get("kind") != "train" or "grid_least_s" not in r or \
            not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
