"""Binary classification metrics, threshold analysis, latent statistics.

Port of `vae_teb_tpu.eval.classification`, numpy throughout (the same
code): ROC and AUC, confusion counts and the binary report, the
per-position metric sweep with its plots and CSV, the strike rate at
fixed false-positive rates, pooled fold results, per-class latent
statistics, and ROC / precision-recall panels. pandas and matplotlib are
imported inside the functions that use them: the card's machine has
neither.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) sorted by descending threshold."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores)
    labels_sorted = labels[order]
    tps = np.cumsum(labels_sorted)
    fps = np.cumsum(~labels_sorted)
    n_pos = max(int(labels.sum()), 1)
    n_neg = max(int((~labels).sum()), 1)
    tpr = np.concatenate([[0.0], tps / n_pos])
    fpr = np.concatenate([[0.0], fps / n_neg])
    thresholds = np.concatenate([[np.inf], scores[order]])
    return fpr, tpr, thresholds


def auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    return float(np.trapezoid(tpr, fpr))


def confusion_at_threshold(labels, scores, threshold: float) -> Dict[str, int]:
    labels = np.asarray(labels).astype(bool)
    pred = np.asarray(scores) >= threshold
    return {"tp": int((pred & labels).sum()),
            "fp": int((pred & ~labels).sum()),
            "tn": int((~pred & ~labels).sum()),
            "fn": int((~pred & labels).sum())}


def binary_classification_report(labels, scores,
                                 threshold: float = 0.5) -> Dict:
    """Accuracy / sensitivity / specificity / precision / F1 / AUC."""
    c = confusion_at_threshold(labels, scores, threshold)
    tp, fp, tn, fn = c["tp"], c["fp"], c["tn"], c["fn"]
    total = max(tp + fp + tn + fn, 1)
    sens = tp / max(tp + fn, 1)
    spec = tn / max(tn + fp, 1)
    prec = tp / max(tp + fp, 1)
    f1 = 2 * prec * sens / max(prec + sens, 1e-12)
    fpr, tpr, _ = roc_curve(labels, scores)
    return {"threshold": threshold, "confusion": c,
            "accuracy": (tp + tn) / total,
            "sensitivity": sens, "specificity": spec,
            "precision": prec, "f1": f1,
            "auc": auc(fpr, tpr)}


def classification_epoch_sweep(results, out_dir: str,
                               epoch_to_hours: float = 1.0 / 3600.0,
                               exclude_epochs: Sequence[float] = ()) -> Dict:
    """Per-window classification metrics swept over the window's position
    in the record (the 'epoch_num' domain start), with metric-vs-hours
    plots, an overall ROC, and CSV/txt summaries — the capability of the
    reference's CSV analysis (utils/data_utils.py:1489-1700,
    analyze_and_plot_classification_metrics).

    results: a pandas DataFrame, a dict of columns, or a CSV path with
    columns guid, epoch_num, prob_class_1, predicted_class, true_label
    (extra columns ignored). Returns {"overall": report,
    "by_epoch": DataFrame} and writes artifacts into out_dir.
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    if isinstance(results, str):
        df = pd.read_csv(results)
    elif isinstance(results, pd.DataFrame):
        df = results.copy()
    else:
        df = pd.DataFrame(results)
    required = {"epoch_num", "prob_class_1", "predicted_class", "true_label"}
    missing = required - set(df.columns)
    if missing:
        raise ValueError(f"results missing columns: {sorted(missing)}")
    if len(exclude_epochs):
        df = df[~df["epoch_num"].isin(list(exclude_epochs))]
    os.makedirs(out_dir, exist_ok=True)

    # overall metrics + ROC
    y_true = df["true_label"].to_numpy()
    y_prob = df["prob_class_1"].to_numpy()
    y_pred = df["predicted_class"].to_numpy()
    overall = binary_classification_report(y_true, y_prob)
    overall["accuracy"] = float((y_true == y_pred).mean())
    fpr, tpr, _ = roc_curve(y_true, y_prob)
    fig, ax = plt.subplots(figsize=(6, 5), constrained_layout=True)
    ax.plot(fpr, tpr, lw=2, label=f"AUC = {overall['auc']:.3f}")
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.set_title("Overall ROC")
    ax.legend(loc="lower right")
    fig.savefig(os.path.join(out_dir, "overall_roc.png"), dpi=110)
    plt.close(fig)
    with open(os.path.join(out_dir, "overall_metrics.txt"), "w") as f:
        for k in ("accuracy", "precision", "sensitivity", "specificity",
                  "f1", "auc"):
            f.write(f"{k}: {overall[k]:.6f}\n")

    # per-epoch-group sweep
    rows = []
    for epoch, g in df.groupby("epoch_num"):
        yt = g["true_label"].to_numpy()
        yp = g["predicted_class"].to_numpy()
        ys = g["prob_class_1"].to_numpy()
        rep = binary_classification_report(yt, ys)
        rows.append({
            "epoch_num": float(epoch),
            "epoch_hours": float(epoch) * epoch_to_hours,
            "n": len(g),
            "accuracy": float((yt == yp).mean()),
            "precision": rep["precision"],
            "recall": rep["sensitivity"],
            "specificity": rep["specificity"],
            "f1": rep["f1"],
            "auc": rep["auc"] if len(np.unique(yt)) > 1 else np.nan,
        })
    by_epoch = pd.DataFrame(rows).sort_values("epoch_num")
    by_epoch.to_csv(os.path.join(out_dir, "group_metrics_by_epoch.csv"),
                    index=False)
    for metric in ("accuracy", "precision", "recall", "specificity",
                   "f1", "auc"):
        fig, ax = plt.subplots(figsize=(7, 4), constrained_layout=True)
        ax.plot(by_epoch["epoch_hours"], by_epoch[metric], marker="o")
        ax.set_xlabel("epoch (hours)")
        ax.set_ylabel(metric)
        ax.set_title(f"{metric} vs record position")
        ax.grid(True, alpha=0.4)
        fig.savefig(os.path.join(out_dir, f"{metric}_vs_epoch.png"), dpi=110)
        plt.close(fig)
    return {"overall": overall, "by_epoch": by_epoch}


def strike_rate_analysis(labels, scores,
                         fpr_targets: Sequence[float] = (0.01, 0.05, 0.10,
                                                         0.20)) -> Dict:
    """Detection ('strike') rate at fixed false-positive-rate operating
    points — the clinical operating-point table of the legacy fold script
    (graph_model_refactored_cls.py:1130)."""
    fpr, tpr, thresholds = roc_curve(labels, scores)
    rows = []
    for target in fpr_targets:
        k = np.searchsorted(fpr, target, side="right") - 1
        k = max(k, 0)
        rows.append({"fpr_target": target,
                     "fpr": float(fpr[k]),
                     "strike_rate": float(tpr[k]),
                     "threshold": float(thresholds[k])})
    return {"operating_points": rows, "auc": auc(fpr, tpr)}


def aggregate_fold_results(fold_results: Dict,
                           positive_class: int = 1) -> Dict:
    """Pool per-fold predictions and report pooled + per-fold metrics."""
    per_fold = {}
    all_scores, all_labels = [], []
    for name, res in fold_results.items():
        scores = res["probabilities"][:, positive_class]
        labels = (np.asarray(res["labels"]) == positive_class).astype(int)
        per_fold[name] = binary_classification_report(labels, scores)
        all_scores.append(scores)
        all_labels.append(labels)
    pooled = binary_classification_report(np.concatenate(all_labels),
                                          np.concatenate(all_scores))
    return {"per_fold": per_fold, "pooled": pooled,
            "mean_auc": float(np.mean([m["auc"]
                                       for m in per_fold.values()]))}


def latent_class_statistics(latents: np.ndarray,
                            labels: np.ndarray) -> Dict:
    """Per-class latent mean/std + between-class separation
    (reference calculate_latent_stats, graph_model_refactored_cls.py:1257).
    latents: (N, S, Z) or (N, Z)."""
    latents = np.asarray(latents)
    if latents.ndim == 3:
        latents = latents.mean(axis=1)
    labels = np.asarray(labels)
    out: Dict = {"classes": {}}
    means = {}
    for cls in np.unique(labels):
        sub = latents[labels == cls]
        means[int(cls)] = sub.mean(axis=0)
        out["classes"][int(cls)] = {
            "count": int(sub.shape[0]),
            "mean": sub.mean(axis=0),
            "std": sub.std(axis=0),
        }
    if len(means) == 2:
        a, b = means.values()
        pooled_std = latents.std(axis=0) + 1e-12
        out["separation"] = float(np.linalg.norm((a - b) / pooled_std)
                                  / np.sqrt(latents.shape[1]))
    return out


def plot_roc_pr_curves(labels, scores, save_path: str,
                       title: str = "") -> None:
    """ROC + precision/recall panels (the reference's
    BinaryClassificationMetricsPlotter role)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    fpr, tpr, _ = roc_curve(labels, scores)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), constrained_layout=True)
    axes[0].plot(fpr, tpr, lw=1.5, label=f"AUC={auc(fpr, tpr):.3f}")
    axes[0].plot([0, 1], [0, 1], "k--", alpha=0.4)
    axes[0].set_xlabel("false positive rate")
    axes[0].set_ylabel("true positive rate (strike rate)")
    axes[0].set_title(f"ROC {title}")
    axes[0].legend()
    # precision-recall via threshold sweep
    order = np.argsort(-scores)
    tp = np.cumsum(labels[order])
    k = np.arange(1, len(scores) + 1)
    precision = tp / k
    recall = tp / max(int(labels.sum()), 1)
    axes[1].plot(recall, precision, lw=1.5)
    axes[1].set_xlabel("recall")
    axes[1].set_ylabel("precision")
    axes[1].set_title("precision-recall")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
