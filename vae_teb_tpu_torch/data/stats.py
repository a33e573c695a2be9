"""Per-channel dataset statistics with post-transform moments.

Port of `vae_teb_tpu.data.stats`: `DatasetStatsCalculator` streams HDF5
files (or batches handed to `update`) and accumulates per-channel count,
sum and sum of squares in float64 on the host, after the production
transforms of `data.normalize`:
  fhr_st: log(clip(x,0)+1e-6) on channels 1.., channel 0 raw
  fhr_ph / fhr_up_ph: asinh everywhere
  fhr / up: raw scalar moments
`save_stats` writes, and `load_stats` reads, the JAX package's file
layout, so a stats file either package writes reads in the other. h5py
is imported inside the functions that touch files, so the package
imports on a machine without it.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .normalize import (DEFAULT_ASINH_CONFIG, DEFAULT_LOG_CONFIG,
                        DEFAULT_LOG_EPSILON, SCALAR_FIELDS, FieldStats,
                        apply_channel_transforms, resolve_channels)

STATS_FIELDS = ("fhr", "up", "fhr_st", "fhr_ph", "fhr_up_ph")


def _batch_moments(data: np.ndarray, log_channels, asinh_channels):
    """(B, C, S) -> per-channel (count, sum, sumsq) after the transforms,
    ignoring non-finite values, in float64."""
    x = apply_channel_transforms(data.astype(np.float64), log_channels,
                                 asinh_channels, DEFAULT_LOG_EPSILON,
                                 channel_axis=1)
    finite = np.isfinite(x)
    xz = np.where(finite, x, 0.0)
    return (finite.sum(axis=(0, 2)), xz.sum(axis=(0, 2)),
            (xz * xz).sum(axis=(0, 2)))


def _batch_moments_scalar(data: np.ndarray):
    x = data.astype(np.float64)
    finite = np.isfinite(x)
    xz = np.where(finite, x, 0.0)
    return finite.sum(), xz.sum(), (xz * xz).sum()


@dataclass
class _Acc:
    count: np.ndarray
    s: np.ndarray
    ss: np.ndarray


class DatasetStatsCalculator:
    """Streaming per-channel moments over one or more HDF5 dataset files.
    `trim_minutes` drops that much from each end of every window (raw
    fields at `sample_rate_hz`, coefficients at 1/`decimation` of it)."""

    def __init__(self, trim_minutes: Optional[float] = None,
                 fields: Sequence[str] = STATS_FIELDS,
                 sample_rate_hz: float = 4.0, decimation: int = 16):
        self.trim_minutes = trim_minutes
        self.fields = tuple(fields)
        if trim_minutes is not None:
            self.trim_raw = int(sample_rate_hz * 60 * trim_minutes)
            self.trim_dec = self.trim_raw // decimation
        else:
            self.trim_raw = self.trim_dec = 0
        self._acc: Dict[str, _Acc] = {}
        self._channels: Dict[str, int] = {}
        self._shapes: Dict[str, tuple] = {}

    def _transform_channels(self, field: str, n_channels: int):
        log_ch = tuple(resolve_channels(DEFAULT_LOG_CONFIG.get(field),
                                        n_channels))
        asinh_ch = tuple(resolve_channels(DEFAULT_ASINH_CONFIG.get(field),
                                          n_channels))
        return log_ch, asinh_ch

    def _trim(self, field: str, data: np.ndarray) -> np.ndarray:
        if self.trim_minutes is None:
            return data
        if field in SCALAR_FIELDS:
            t = self.trim_raw
            return data[:, t:-t] if t else data
        t = self.trim_dec
        return data[:, :, t:-t] if t else data

    def update(self, field: str, data: np.ndarray) -> None:
        """Accumulate one batch (B, S) or (B, C, S), pre-trim layout."""
        data = self._trim(field, np.asarray(data))
        self._shapes.setdefault(field, data.shape[1:])
        if field in SCALAR_FIELDS:
            c, s, ss = _batch_moments_scalar(data)
            acc = self._acc.setdefault(
                field, _Acc(np.zeros(()), np.zeros(()), np.zeros(())))
        else:
            n_ch = data.shape[1]
            self._channels[field] = n_ch
            c, s, ss = _batch_moments(data,
                                      *self._transform_channels(field, n_ch))
            acc = self._acc.setdefault(
                field, _Acc(np.zeros(n_ch), np.zeros(n_ch), np.zeros(n_ch)))
        acc.count = acc.count + c
        acc.s = acc.s + s
        acc.ss = acc.ss + ss

    def calculate_stats(self, hdf5_files: Sequence[str],
                        batch_size: int = 64) -> Dict[str, FieldStats]:
        """Stream every file and field through `update`, then finalize."""
        import h5py
        for path in hdf5_files:
            with h5py.File(path, "r") as f:
                n = f["fhr"].shape[0]
                for start in range(0, n, batch_size):
                    sl = slice(start, min(start + batch_size, n))
                    for field in self.fields:
                        if field in f:
                            self.update(field, f[field][sl])
        return self.finalize()

    def finalize(self) -> Dict[str, FieldStats]:
        out: Dict[str, FieldStats] = {}
        for field, acc in self._acc.items():
            safe = np.where(acc.count > 0, acc.count, 1)
            mean = acc.s / safe
            var = np.maximum(acc.ss / safe - mean ** 2, 0.0)
            mean = np.where(acc.count > 0, mean, 0.0)
            var = np.where(acc.count > 0, var, 0.0)
            if field in SCALAR_FIELDS:
                out[field] = FieldStats(mean=np.float32(mean),
                                        variance=np.float32(var),
                                        count=int(acc.count))
            else:
                log_ch, asinh_ch = self._transform_channels(
                    field, self._channels[field])
                out[field] = FieldStats(mean=mean.astype(np.float32),
                                        variance=var.astype(np.float32),
                                        log_channels=log_ch,
                                        asinh_channels=asinh_ch,
                                        count=int(acc.count.sum()))
        return out

    def save_stats(self, stats: Dict[str, FieldStats], output_path: str,
                   metadata: Optional[Dict] = None) -> None:
        """Write `stats` in the JAX package's stats-file layout."""
        import h5py
        with h5py.File(output_path, "w", libver="latest") as f:
            if metadata:
                mg = f.create_group("metadata")
                for k, v in metadata.items():
                    mg.attrs[k] = v
            f.attrs["created_at"] = datetime.datetime.now().isoformat()
            f.attrs["trim_minutes"] = (self.trim_minutes
                                       if self.trim_minutes is not None
                                       else -1.0)
            f.attrs["log_epsilon"] = DEFAULT_LOG_EPSILON
            for field, st in stats.items():
                g = f.create_group(field)
                g.attrs["shape"] = self._shapes.get(field, np.shape(st.mean))
                g.attrs["count"] = st.count
                g.create_dataset("mean", data=st.mean, dtype="f4")
                g.create_dataset("variance", data=st.variance, dtype="f4")
                g.create_dataset("std", data=np.sqrt(st.variance), dtype="f4")
                if field in SCALAR_FIELDS:
                    g.attrs["mean_scalar"] = float(st.mean)
                    g.attrs["variance_scalar"] = float(st.variance)
                    g.attrs["std_scalar"] = float(np.sqrt(st.variance))
                    continue
                n_ch = len(st.mean)
                g.attrs["n_channels"] = n_ch
                g.attrs["regular_channels"] = [
                    c for c in range(n_ch) if c not in st.log_channels
                    and c not in st.asinh_channels]
                g.attrs["log_channels"] = list(st.log_channels)
                g.attrs["asinh_channels"] = list(st.asinh_channels)
                g.attrs["uses_log_transform"] = len(st.log_channels) > 0
                g.attrs["uses_asinh_transform"] = len(st.asinh_channels) > 0


def load_stats(stats_path: str) -> Dict[str, FieldStats]:
    """Load a stats file written by either package or the reference."""
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
