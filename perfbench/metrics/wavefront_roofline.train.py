"""wavefront_roofline.train: share of the roofline: the least time of the traced steps' LSTM work
(`counts.wavefront_least_s`) over the device time of the operations whose
name holds `wavefront` in the profiler's trace of those steps, in %.

Layer: Wavefront kernels (`kernels.wavefront`, `wavefront_*.cu`). Moves `train_windows_per_s`. Reads the harness's readings of a
`--trace 1` run; returns None where it finds nothing to read."""


def read(r):
    tr = r.get("trace") or {}
    spent = sum(s for k, s in tr.get("kernels", {}).items()
                if "wavefront" in k)
    if r.get("kind") != "train" or not spent or not tr.get("units"):
        return None
    return 100.0 * r["wavefront_least_s"] * tr["units"] / spent
