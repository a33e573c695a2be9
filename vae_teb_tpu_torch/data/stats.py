"""Reading normalization statistics files.

Port of the read side of `vae_teb_tpu.data.stats` (`load_stats`,
`stats_file_trim_minutes`); the file layout is the JAX package's and the
reference's. h5py is imported inside the functions that read, so the
package imports on a machine without it. `DatasetStatsCalculator` (the
write side) is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .normalize import DEFAULT_LOG_EPSILON, SCALAR_FIELDS, FieldStats

STATS_FIELDS = ("fhr", "up", "fhr_st", "fhr_ph", "fhr_up_ph")


def load_stats(stats_path: str) -> Dict[str, FieldStats]:
    """Load a stats file written by the JAX package or the reference."""
    import h5py
    out: Dict[str, FieldStats] = {}
    with h5py.File(stats_path, "r") as f:
        log_eps = float(f.attrs.get("log_epsilon", DEFAULT_LOG_EPSILON))
        for field in f.keys():
            if field == "metadata":
                continue
            g = f[field]
            if field in SCALAR_FIELDS:
                out[field] = FieldStats(
                    mean=np.float32(g.attrs["mean_scalar"]),
                    variance=np.float32(g.attrs["variance_scalar"]),
                    log_epsilon=log_eps, count=int(g.attrs.get("count", 0)))
                continue
            mean = g["mean"][()]
            var = g["variance"][()]
            n_ch = len(mean)
            if "log_channels" in g.attrs:
                log_ch = tuple(int(c) for c in g.attrs["log_channels"])
                asinh_ch = tuple(int(c)
                                 for c in g.attrs.get("asinh_channels", []))
            elif "order0_channels" in g.attrs:
                # older stats files name the raw channels instead
                order0 = set(int(c) for c in g.attrs["order0_channels"])
                log_ch = tuple(c for c in range(n_ch) if c not in order0)
                asinh_ch = ()
            else:
                log_ch, asinh_ch = (), ()
            out[field] = FieldStats(mean=mean.astype(np.float32),
                                    variance=var.astype(np.float32),
                                    log_channels=log_ch,
                                    asinh_channels=asinh_ch,
                                    log_epsilon=log_eps,
                                    count=int(g.attrs.get("count", 0)))
    return out


def stats_file_trim_minutes(stats_path: str) -> float:
    """The trim the statistics were computed over (-1.0: untrimmed)."""
    import h5py
    with h5py.File(stats_path, "r") as f:
        return float(f.attrs.get("trim_minutes", -1.0))
