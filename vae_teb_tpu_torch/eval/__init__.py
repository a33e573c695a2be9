"""Evaluation: transfer entropy, reconstruction metrics, the causality
analyses, the coefficient-domain battery, plots and the full suite.

Port of `vae_teb_tpu.eval`, with the classification metrics
(`classification`) and the predict-st battery (`prediction_accuracy_test`).
matplotlib, pandas and sklearn are imported inside the functions that use
them.
"""

from .analyses import GAINS_DEFAULT, SHIFT_SECONDS_DEFAULT, ModelEvaluator
from .metrics import (calculate_vaf, discretize_signal,
                      gaussian_log_likelihood, gaussian_mutual_information,
                      histogram_mutual_information, interpolate_latent,
                      reconstruction_metrics)
from .classification import (aggregate_fold_results, auc,
                             binary_classification_report,
                             classification_epoch_sweep,
                             confusion_at_threshold, latent_class_statistics,
                             plot_roc_pr_curves, roc_curve,
                             strike_rate_analysis)
from .predict_st import (coefficient_error_stats, prediction_accuracy_test,
                         seqvae_mse_test)
from .suite import run_evaluation_suite

__all__ = [
    "ModelEvaluator", "SHIFT_SECONDS_DEFAULT", "GAINS_DEFAULT",
    "calculate_vaf", "discretize_signal", "gaussian_log_likelihood",
    "gaussian_mutual_information", "histogram_mutual_information",
    "interpolate_latent", "reconstruction_metrics",
    "run_evaluation_suite",
    "coefficient_error_stats", "prediction_accuracy_test", "seqvae_mse_test",
    "aggregate_fold_results", "auc", "binary_classification_report",
    "classification_epoch_sweep", "confusion_at_threshold",
    "latent_class_statistics", "plot_roc_pr_curves", "roc_curve",
    "strike_rate_analysis",
]
