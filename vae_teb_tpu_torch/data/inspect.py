"""Dataset inspection: structure dumps and per-sample visualizations.

Port of `vae_teb_tpu.data.inspect`: file structure / dtype / size
reports, per-field value statistics, and a per-sample panel (raw FHR/UP
traces + the three coefficient images). h5py and matplotlib are imported
inside the functions that use them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def describe_hdf5(path: str, sample_stats: bool = True,
                  max_stat_samples: int = 32) -> Dict:
    """Structure + per-field statistics report for a dataset file."""
    import h5py
    out: Dict = {"path": path, "fields": {}}
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            info = {"shape": tuple(ds.shape), "dtype": str(ds.dtype),
                    "chunks": ds.chunks,
                    "compression": ds.compression,
                    "size_mb": ds.nbytes / 1024 ** 2}
            if sample_stats and ds.shape[0] and ds.dtype.kind == "f":
                n = min(max_stat_samples, ds.shape[0])
                vals = ds[:n]
                info.update(min=float(np.nanmin(vals)),
                            max=float(np.nanmax(vals)),
                            mean=float(np.nanmean(vals)),
                            std=float(np.nanstd(vals)),
                            n_nan=int(np.isnan(vals).sum()))
            out["fields"][name] = info
        out["n_samples"] = int(f["fhr"].shape[0]) if "fhr" in f else 0
        out["attrs"] = {k: f.attrs[k] for k in f.attrs}
    return out


def format_report(desc: Dict) -> str:
    lines = [f"{desc['path']}: {desc['n_samples']} samples"]
    for name, info in desc["fields"].items():
        stat = ""
        if "mean" in info:
            stat = (f"  range [{info['min']:.3g}, {info['max']:.3g}] "
                    f"mean {info['mean']:.3g} std {info['std']:.3g}"
                    + (f" NaN={info['n_nan']}" if info["n_nan"] else ""))
        lines.append(f"  {name:10s} {str(info['shape']):18s} "
                     f"{info['dtype']:8s} {info['size_mb']:8.2f} MB{stat}")
    return "\n".join(lines)


def plot_sample(path: str, sample_idx: int, save_path: str,
                sample_rate_hz: float = 4.0) -> None:
    """Raw traces + coefficient images for one stored sample."""
    import h5py
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    with h5py.File(path, "r") as f:
        fhr = f["fhr"][sample_idx]
        up = f["up"][sample_idx]
        coeffs = {name: f[name][sample_idx]
                  for name in ("fhr_st", "fhr_ph", "fhr_up_ph") if name in f}
        guid = f["guid"][sample_idx]
        guid = guid.decode() if isinstance(guid, bytes) else str(guid)
    n_rows = 1 + len(coeffs)
    fig, axes = plt.subplots(n_rows, 1, figsize=(14, 3 * n_rows),
                             constrained_layout=True)
    t = np.arange(len(fhr)) / sample_rate_hz
    ax0 = axes[0] if n_rows > 1 else axes
    ax0.plot(t, fhr, lw=0.6, label="FHR")
    ax0twin = ax0.twinx()
    ax0twin.plot(t, up, lw=0.6, color="C1", label="UP")
    ax0.set_title(f"sample {sample_idx} guid={guid}")
    ax0.set_xlabel("time [s]")
    for ax, (name, data) in zip(axes[1:], coeffs.items()):
        # log-compress for display: coefficients span orders of magnitude
        img = np.arcsinh(data)
        im = ax.imshow(img, aspect="auto", origin="lower", cmap="magma")
        ax.set_title(f"{name} (asinh display) {data.shape}")
        fig.colorbar(im, ax=ax)
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
