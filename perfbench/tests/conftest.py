"""Small sizes at which every cell runs on the CPU through the plain paths,
and the card fixture of the `cuda` tests."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# H=8 encoders; a frontend of J=6, Q=2, T=8 over 1024 samples (14
# scattering, 24 phase and 24 cross channels, 68 steps kept, the raw
# target 8 samples a step)
SERVE_SMALL = {"model": {"lstm_hidden_dim": 8, "seq_len": 68,
                         "n_scattering": 14, "n_phase": 24,
                         "input_channels": 24, "decimation_factor": 8},
               "frontend": {"J": 6, "Q": 2, "T": 8, "N": 1024,
                            "production": False}}
TRAIN_SMALL = SERVE_SMALL
TRAIN_TRAFFIC = {"batch": 4, "steps_per_execution": 2, "pool_windows": 16,
                 "trace_after_groups": 1, "trace_groups": 1}
SERVE_TRAFFIC = {"batch": 2, "sample_rate_per_s": 0.5,
                 "checked_requests": 2, "trace_after_requests": 1,
                 "trace_requests": 2}


def small(workload: str):
    """(config overrides, traffic overrides) of a cell at the small size."""
    if workload.startswith("train."):
        return TRAIN_SMALL, TRAIN_TRAFFIC
    return SERVE_SMALL, SERVE_TRAFFIC


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
