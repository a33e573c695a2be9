"""Per-channel frequency annotation of the scattering/phase coefficients.

Port of `vae_teb_tpu.ops.frequency_analysis` (numpy only): center
frequency and bandwidth in Hz, physiological band labels, harmonic
relationship classification and coefficient counts, read straight from
`ops.filterbank.calibrate` so the annotations follow the filters in use.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .filterbank import calibrate
from .phase import build_pair_table


def physiological_band(freq_hz: float) -> str:
    """FHR physiological band label."""
    if freq_hz < 0.1:
        return "Ultra-low frequency (ULF)"
    if freq_hz < 0.5:
        return "Very low frequency (VLF)"
    if freq_hz < 1.0:
        return "Low frequency (LF)"
    if freq_hz < 2.0:
        return "High frequency (HF)"
    return "Very high frequency (VHF)"


def classify_harmonic_relationship(power: float) -> str:
    """Harmonic-ratio label for a phase pair."""
    if abs(power - 1.0) < 0.01:
        return "Auto-correlation (1:1)"
    if abs(power - 2.0) < 0.1:
        return "Octave (1:2)"
    if abs(power - 1.5) < 0.1:
        return "Perfect Fifth (2:3)"
    if abs(power - 3.0) < 0.1:
        return "Octave + Fifth (1:3)"
    if abs(power - 4.0) < 0.1:
        return "Double Octave (1:4)"
    if power < 1.5:
        return "Close frequencies"
    if power < 3.0:
        return "Harmonic relationship"
    return "High harmonic ratio"


def _annotate(xis, sigmas, js, fs: float) -> List[Dict]:
    out = []
    for i, (xi, sigma, j) in enumerate(zip(xis, sigmas, js)):
        center = xi * fs
        bw = 2.0 * sigma * fs  # Morlet effective bandwidth ~ 2 sigma fs
        out.append({
            "filter_index": i,
            "xi_normalized": float(xi),
            "sigma_normalized": float(sigma),
            "center_freq_hz": center,
            "bandwidth_hz": bw,
            "frequency_range_hz": (center - bw / 2, center + bw / 2),
            "max_subsampling_j": int(j),
            "physiological_band": physiological_band(center),
        })
    return out


def analyze_scattering_frequencies(J: int, Q: int, T: int,
                                   sampling_rate: float = 4.0,
                                   signal_duration_minutes: float = 24.0
                                   ) -> Dict:
    """Full frequency report for a scattering configuration."""
    sigma_low, xi1, sig1, j1, xi2, sig2, j2 = calibrate(J, Q, T)
    fs = sampling_rate
    first = _annotate(xi1, sig1, j1, fs)
    second = _annotate(xi2, sig2, j2, fs)

    pairs = build_pair_table(np.asarray(xi1, dtype=np.float32))
    pair_info = []
    for k in range(len(pairs)):
        i, j = int(pairs.i_idx[k]), int(pairs.j_idx[k])
        power = float(pairs.powers[k])
        pair_info.append({
            "pair_index": k,
            "filter_i": i, "filter_j": j,
            "xi_i_hz": float(xi1[i]) * fs, "xi_j_hz": float(xi1[j]) * fs,
            "power": power,
            "is_auto": i == j,
            "harmonic_type": classify_harmonic_relationship(power),
        })

    n2_pairs = sum(1 for a in j1 for b in j2 if b > a)
    duration_s = signal_duration_minutes * 60.0
    return {
        "config": {"J": J, "Q": Q, "T": T, "sampling_rate_hz": fs,
                   "signal_duration_s": duration_s,
                   "num_samples": int(fs * duration_s),
                   "nyquist_hz": fs / 2.0},
        "first_order": first,
        "second_order": second,
        "low_pass": {"sigma_normalized": float(sigma_low),
                     "bandwidth_hz": 2.0 * sigma_low * fs,
                     "cutoff_freq_hz": sigma_low * fs},
        "phase_pairs": pair_info,
        "counts": {"order0": 1, "order1": len(first), "order2": n2_pairs,
                   "phase_pairs": len(pair_info),
                   "auto_pairs": int(len(pairs.autoc_idx))},
    }


def channel_labels(analysis: Dict, max_order: int = 1) -> List[str]:
    """Human-readable labels for the stacked scattering channel axis
    ([order0, order1..., order2...]) used in analysis plots."""
    labels = ["order0 (low-pass)"]
    for f in analysis["first_order"]:
        labels.append(f"o1 #{f['filter_index']} "
                      f"{f['center_freq_hz']:.4f} Hz "
                      f"[{f['physiological_band'].split('(')[-1].rstrip(')')}]")
    if max_order >= 2:
        # order-2 channels are (n1, n2) pairs with j2 > j1, n1-major
        first, second = analysis["first_order"], analysis["second_order"]
        for f1 in first:
            for f2 in second:
                if f2["max_subsampling_j"] > f1["max_subsampling_j"]:
                    labels.append(
                        f"o2 ({f1['filter_index']},{f2['filter_index']}) "
                        f"{f1['center_freq_hz']:.3f}x{f2['center_freq_hz']:.3f} Hz")
    return labels


def print_detailed_analysis(analysis: Dict) -> str:
    """Formatted table report. Returns the string (and prints it)."""
    lines = []
    cfg = analysis["config"]
    lines.append(f"Scattering config J={cfg['J']} Q={cfg['Q']} T={cfg['T']} "
                 f"fs={cfg['sampling_rate_hz']} Hz "
                 f"(nyquist {cfg['nyquist_hz']} Hz)")
    lp = analysis["low_pass"]
    lines.append(f"low-pass: cutoff {lp['cutoff_freq_hz']:.5f} Hz, "
                 f"bandwidth {lp['bandwidth_hz']:.5f} Hz")
    lines.append(" idx |   xi_norm  |  center Hz | bandwidth Hz | j | band")
    for f in analysis["first_order"]:
        lines.append(f" {f['filter_index']:3d} | {f['xi_normalized']:.6f} | "
                     f"{f['center_freq_hz']:10.4f} | {f['bandwidth_hz']:12.4f} | "
                     f"{f['max_subsampling_j']} | {f['physiological_band']}")
    c = analysis["counts"]
    lines.append(f"counts: order1={c['order1']} order2={c['order2']} "
                 f"phase_pairs={c['phase_pairs']} (auto={c['auto_pairs']})")
    text = "\n".join(lines)
    print(text)
    return text
