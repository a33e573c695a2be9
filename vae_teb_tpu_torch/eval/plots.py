"""Matplotlib analysis plots (headless, Agg).

Port of `vae_teb_tpu.eval.plots`, function for function: model analysis
panels, reconstruction overlays, TE-vs-shift curves, metric histograms,
ablation and gain summaries, latent-interpolation grids and GIF, and
training-history curves. They take numpy arrays. matplotlib is imported
inside each function (`_pyplot`), so the package imports on a machine
without it, where each function raises ModuleNotFoundError.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_model_analysis(y_raw: np.ndarray, mu_pr: np.ndarray,
                        te_map: np.ndarray, z: np.ndarray,
                        save_path: str, title: str = "") -> None:
    """Reconstruction + latent + per-step/per-dim TE heatmap panels for one
    sample."""
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(14, 10), constrained_layout=True)
    t = np.arange(len(y_raw)) / 4.0
    axes[0].plot(t, y_raw, lw=0.6, label="signal")
    axes[0].plot(t, mu_pr, lw=0.6, label="reconstruction")
    axes[0].set_xlabel("time [s]")
    axes[0].legend(loc="upper right")
    axes[0].set_title(f"raw-signal reconstruction {title}")
    im = axes[1].imshow(te_map.T, aspect="auto", origin="lower",
                        cmap="viridis")
    axes[1].set_title("transfer entropy per step / latent dim")
    axes[1].set_xlabel("sequence step")
    axes[1].set_ylabel("latent dim")
    fig.colorbar(im, ax=axes[1])
    im2 = axes[2].imshow(z.T, aspect="auto", origin="lower", cmap="coolwarm")
    axes[2].set_title("latent trajectory z")
    fig.colorbar(im2, ax=axes[2])
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_vae_reconstruction(y_raw: np.ndarray, mu: np.ndarray,
                            logvar: Optional[np.ndarray],
                            save_path: str, title: str = "") -> None:
    """Signal vs reconstruction with a +-2 sigma uncertainty band."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(14, 4), constrained_layout=True)
    t = np.arange(len(y_raw)) / 4.0
    ax.plot(t, y_raw, lw=0.7, color="k", label="signal")
    ax.plot(t, mu, lw=0.7, color="C1", label="reconstruction mu")
    if logvar is not None:
        sd = np.exp(0.5 * logvar)
        ax.fill_between(t, mu - 2 * sd, mu + 2 * sd, alpha=0.25, color="C1",
                        label="+-2 sigma")
    ax.set_xlabel("time [s]")
    ax.legend(loc="upper right")
    ax.set_title(title or "VAE reconstruction")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_transfer_entropy_vs_shift(shift_seconds: np.ndarray, te: np.ndarray,
                                   save_path: str, title: str = "") -> None:
    """TE as a function of circular UP shift."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 4), constrained_layout=True)
    ax.plot(shift_seconds, te, marker="o", ms=3)
    zero = np.where(np.asarray(shift_seconds) == 0)[0]
    if zero.size:
        ax.axvline(0, color="r", ls="--", alpha=0.6, label="no shift")
        ax.legend()
    ax.set_xlabel("UP shift [s]")
    ax.set_ylabel("mean transfer entropy")
    ax.set_title(title or "transfer entropy vs UP shift")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_metrics_histograms(metrics: Dict[str, np.ndarray],
                            save_path: str) -> None:
    """VAF / MSE / SNR / KLD histograms (every key when none of those)."""
    plt = _pyplot()
    preferred = [k for k in ("vaf", "mse", "snr_db", "kld") if k in metrics]
    keys = preferred or sorted(metrics)
    if not keys:
        return
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3.5),
                             constrained_layout=True)
    if len(keys) == 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        vals = np.asarray(metrics[k])
        ax.hist(vals, bins=30, alpha=0.8)
        ax.axvline(vals.mean(), color="r", ls="--")
        ax.set_title(f"{k}: {vals.mean():.4g} +- {vals.std():.4g}")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_te_ablation_results(results: Dict[str, np.ndarray],
                             save_path: str) -> None:
    """With/without-UP TE + VAF distributions."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), constrained_layout=True)
    for ax, (a, b, label) in zip(axes, [
            ("te_with_up", "te_without_up", "transfer entropy"),
            ("vaf_with_up", "vaf_without_up", "VAF")]):
        wa, wo = np.asarray(results[a]), np.asarray(results[b])
        ax.boxplot([wa, wo], tick_labels=["with UP", "without UP"])
        ax.set_title(f"{label}: {wa.mean():.4g} vs {wo.mean():.4g}")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_te_gain_sweep(gains: np.ndarray, te: np.ndarray,
                       save_path: str, title: str = "") -> None:
    """TE vs UP gain. te may be (K,) for one
    sample or (N, K) for many."""
    plt = _pyplot()
    te = np.atleast_2d(np.asarray(te))
    fig, ax = plt.subplots(figsize=(7, 4), constrained_layout=True)
    mean = te.mean(axis=0)
    ax.plot(gains, mean, marker="o", label="mean TE")
    if te.shape[0] > 1:
        ax.fill_between(gains, mean - te.std(axis=0), mean + te.std(axis=0),
                        alpha=0.25)
    ax.axvline(1.0, color="r", ls="--", alpha=0.6, label="nominal gain")
    ax.set_xlabel("UP gain")
    ax.set_ylabel("mean transfer entropy")
    ax.set_title(title or "transfer entropy vs UP gain")
    ax.legend()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def plot_latent_interpolation(z_latents: np.ndarray,
                              decoder_outputs: np.ndarray,
                              save_prefix: str,
                              len_signal: int = 4800,
                              sample_rate_hz: float = 4.0) -> None:
    """Heatmap grids of interpolated latents and their decodings: one row
    per interpolation step; writes <prefix>_z_latent.png and
    <prefix>_decoder.png.

    z_latents: (K, D, S) latent trajectories; decoder_outputs: (K, C, S).
    """
    plt = _pyplot()
    dur = len_signal / sample_rate_hz
    for arr, tag, ylabel in ((np.asarray(z_latents), "z_latent", "z"),
                             (np.asarray(decoder_outputs), "decoder", "y")):
        k = arr.shape[0]
        fig, axes = plt.subplots(nrows=k, ncols=1,
                                 figsize=(12, 2.2 * k + 1), squeeze=False,
                                 constrained_layout=True)
        for i in range(k):
            im = axes[i, 0].imshow(arr[i], aspect="auto",
                                   extent=[0, dur, arr[i].shape[0], 0])
            fig.colorbar(im, ax=axes[i, 0])
            axes[i, 0].set_ylabel(ylabel)
            if i < k - 1:
                axes[i, 0].set_xticklabels([])
        axes[-1, 0].set_xlabel("time (s)")
        fig.savefig(f"{save_prefix}_{tag}.png", dpi=100)
        plt.close(fig)


def animate_latent_interpolation(z_latents: np.ndarray,
                                 decoder_outputs: np.ndarray,
                                 save_path: str,
                                 len_signal: int = 4800,
                                 sample_rate_hz: float = 4.0,
                                 interval_ms: int = 150) -> None:
    """GIF sweeping through the latent interpolation frames (pillow)."""
    plt = _pyplot()
    from matplotlib import animation
    z = np.asarray(z_latents)
    y = np.asarray(decoder_outputs)
    dur = len_signal / sample_rate_hz
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 6),
                                   constrained_layout=True)
    im1 = ax1.imshow(z[0], aspect="auto", extent=[0, dur, z[0].shape[0], 0],
                     vmin=z.min(), vmax=z.max())
    ax1.set_ylabel("z")
    fig.colorbar(im1, ax=ax1)
    im2 = ax2.imshow(y[0], aspect="auto", extent=[0, dur, y[0].shape[0], 0],
                     vmin=y.min(), vmax=y.max())
    ax2.set_ylabel("y")
    fig.colorbar(im2, ax=ax2)

    def frame(i):
        im1.set_data(z[i])
        im2.set_data(y[i])
        return im1, im2

    ani = animation.FuncAnimation(fig, frame, frames=z.shape[0], blit=True,
                                  repeat=False, interval=interval_ms)
    ani.save(save_path, writer="pillow", dpi=80)
    plt.close(fig)


def plot_loss_curves(history: Dict[str, Sequence[float]],
                     save_path: str) -> None:
    """Train/val loss curves (log scale) from the trainer history."""
    plt = _pyplot()
    loss_keys = [k for k in history
                 if k.startswith(("train/", "val/")) and "loss" in k]
    fig, ax = plt.subplots(figsize=(9, 5), constrained_layout=True)
    for k in sorted(loss_keys):
        ax.plot(history["epoch"], history[k], label=k, lw=1.2)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
