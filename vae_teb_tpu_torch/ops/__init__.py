"""Signal-processing operators: filter banks, scattering, phase harmonics
(exact and reduced rate), frequency annotation."""

from .filterbank import FilterBank, build_filter_bank, calibrate, output_size
from .frequency_analysis import (analyze_scattering_frequencies,
                                 channel_labels, physiological_band)
from .phase import (PairTable, PhaseScattering1D, build_pair_table,
                    select_cross_coefficients, select_phase_coefficients)
from .scattering import Scattering1D, reflect_pad, subsample_fourier, tukey_window

__all__ = [
    "FilterBank", "build_filter_bank", "calibrate", "output_size",
    "analyze_scattering_frequencies", "channel_labels", "physiological_band",
    "Scattering1D", "reflect_pad", "subsample_fourier", "tukey_window",
    "PairTable", "PhaseScattering1D", "build_pair_table",
    "select_phase_coefficients", "select_cross_coefficients",
]
