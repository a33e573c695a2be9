"""The yardstick's counts: the analytic model FLOPs against PyTorch's own
count of the reference's plain training step, and the wavefront work at
the unpadded hidden size."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from perfbench import weights
from perfbench.counts import (HBM_BYTES_PER_S, PEAK_FLOPS, forward_flops,
                              step_flops, wavefront_least_s)
from perfbench.reference.model import Model, elbo, is_buffer, param_shapes

MODEL = {"input_channels": 130, "n_scattering": 43, "n_phase": 44,
         "lstm_hidden_dim": 64, "lstm_num_layers": 4, "latent_dim": 32,
         "seq_len": 300, "decimation_factor": 16}


@pytest.mark.parametrize("H,S,B", [(8, 12, 3), (12, 20, 2)])
def test_flops_match_flop_counter(H, S, B):
    """Forward and backward of the reference: 3x the analytic forward,
    but that the first step's recurrent product of each layer has no
    input gradient (its state is the zero start): the LSTM's recurrent
    products are counted apart."""
    cfg = dict(MODEL, lstm_hidden_dim=H, seq_len=S)
    shapes = param_shapes(cfg)
    made = weights.make(shapes, 3, "cpu", torch.float64)
    P = {n: v.requires_grad_(not is_buffer(n)) for n, v in made.items()}
    g = torch.Generator().manual_seed(3)

    def fields(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)
    y_st = fields(B, S, cfg["n_scattering"])
    y_ph = fields(B, S, cfg["n_phase"])
    x_ph = fields(B, S, cfg["input_channels"])
    y_raw = fields(B, S * cfg["decimation_factor"])
    eps = torch.randn(B, S, cfg["latent_dim"], dtype=torch.float64)
    counter = FlopCounterMode(display=False)
    with counter:
        out = Model(cfg, P).forward(y_st, y_ph, x_ph, eps)
        elbo(out, y_st, y_ph, y_raw, 1e-5)["total_loss"].backward()
    f = forward_flops(cfg)
    rec_step = f["lstm_recurrent"] / S        # every layer's product, a step
    want = 3 * B * (f["dense"] + f["conv"] + f["lstm_input"]) + \
        B * (3 * S - 1) * rec_step
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-12)
    assert step_flops(cfg, B, True) == pytest.approx(3 * B * sum(f.values()))


def test_flops_of_the_published_model():
    f = forward_flops(MODEL)
    heads = 2 * 2 * 2 * 4800 * 4800           # two heads of two layers
    assert f["dense"] > heads
    assert f["lstm_recurrent"] == 2 * 4 * 2 * 64 * 256 * 300
    assert f["lstm_input"] == (2 * 32 * 256 + 2 * 20 * 256
                               + 6 * 2 * 64 * 256) * 300


def _least(H, B, S, L, item, peak, training):
    blocks = 2 * L - 1
    flops = 2 * blocks * 2 * H * 4 * H * B * S
    w = blocks * H * 4 * H
    states, seqs = 4 * L * B * H, 2 * L * S * B * H
    fwd = w + S * B * 4 * H + states + (seqs if training else S * B * H)
    t = max(flops / peak, 2 * fwd * item / HBM_BYTES_PER_S)
    if training:
        rev = w + S * B * 4 * H + seqs + S * B * H + states + L * S * B * 4 * H
        t += max(flops / peak, 2 * rev * item / HBM_BYTES_PER_S)
    return t


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("training", [False, True])
def test_wavefront_work_is_unpadded(precision, training):
    """H=60 is counted as 60, not as the 64 the kernels pack it to."""
    cfg = dict(MODEL, lstm_hidden_dim=60, precision=precision)
    item = 4 if precision == "fp32" else 2
    got = wavefront_least_s(cfg, 128, training)
    assert got == pytest.approx(_least(60, 128, 300, 4, item,
                                       PEAK_FLOPS[precision], training))
    assert got < wavefront_least_s(dict(cfg, lstm_hidden_dim=64), 128,
                                   training)
    assert math.isfinite(got) and got > 0
    assert np.isclose(PEAK_FLOPS["fp32"], 495e12 / 3)
