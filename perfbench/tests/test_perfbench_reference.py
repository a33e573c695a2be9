"""The plain reference computes what the program computes: its frontend
against the program's reduced-rate frontend, its model and training step
against the program's on the CPU, at small sizes, float64 against the
program's float32."""

import numpy as np
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from perfbench import data, weights
from perfbench.checks import of_max, rel_l2
from perfbench.reference.frontend import Frontend
from perfbench.reference.model import Model, elbo, param_shapes

SMALL = {"input_channels": 24, "n_scattering": 14, "n_phase": 24,
         "lstm_hidden_dim": 8, "lstm_num_layers": 4, "latent_dim": 32,
         "seq_len": 20, "decimation_factor": 16}


def _program_model(cfg, seed, dtype=None):
    from vae_teb_tpu_torch import SeqVaeTeb
    model = SeqVaeTeb(
        input_channels=cfg["input_channels"], n_scattering=cfg["n_scattering"],
        n_phase=cfg["n_phase"], lstm_hidden_dim=cfg["lstm_hidden_dim"],
        lstm_num_layers=cfg["lstm_num_layers"], seq_len=cfg["seq_len"],
        dtype=dtype, decimation_factor=cfg["decimation_factor"])
    shapes = param_shapes(cfg)
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == dict(shapes)
    weights.fill(state, shapes, seed)
    return model, shapes


@pytest.mark.parametrize("J,Q,T,N", [(6, 2, 8, 1024), (8, 4, 16, 2048)])
def test_frontend_matches_the_program(J, Q, T, N):
    from vae_teb_tpu_torch import PhaseScattering1D
    from vae_teb_tpu_torch.serve import WindowFrontend
    prog = WindowFrontend(PhaseScattering1D(J=J, Q=Q, T=T, shape=N,
                                            max_order=1, reduced_rate=True))
    ref = Frontend(J, Q, T, N, 30)
    fhr, up = (torch.as_tensor(a) for a in data.raw_windows(3, N, 4, 0))
    got, want = prog(fhr, up), ref(fhr, up)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert rel_l2(got[0], want[0]) < 1e-6
    assert rel_l2(got[1], want[1]) < 2e-5
    # non-integer accelerations of nearly cancelling products: float32
    # rounding alone moves the cross family by ~1e-3 (rel-L2)
    assert rel_l2(got[2], want[2]) < 1e-2


@pytest.mark.parametrize("train", [False, True])
def test_model_matches_the_program(train):
    model, shapes = _program_model(SMALL, 5)
    P = {k: v.double() for k, v in weights.make(shapes, 5, "cpu").items()}
    B, S = 3, SMALL["seq_len"]
    g = torch.Generator().manual_seed(2)
    y_st = torch.randn(B, S, 14, generator=g)
    y_ph = torch.randn(B, S, 24, generator=g)
    x_ph = torch.randn(B, S, 24, generator=g)
    eps = torch.randn(B, S, 32, generator=g)
    model.train(train)
    out = model(y_st, y_ph, x_ph, deterministic=not train, eps=eps)
    ref = Model(SMALL, P, train=train).forward(y_st, y_ph, x_ph,
                                               eps if train else None)
    for k, v in ref.items():
        assert of_max(out[k].detach(), v) < 1e-5, k
    y_raw = torch.randn(B, 16 * S, generator=g)
    from vae_teb_tpu_torch.models.vae_teb import compute_loss
    got = compute_loss(out, y_st, y_ph, y_raw, beta=1e-5)["total_loss"]
    want = elbo(ref, y_st, y_ph, y_raw, 1e-5)["total_loss"]
    assert abs(float(got.detach()) - float(want)) < 1e-5 * abs(float(want))


def test_weights_depend_on_the_seed_alone():
    shapes = param_shapes(SMALL)
    a = weights.make(shapes, 9, "cpu")
    b = weights.make(shapes, 9, "cpu", torch.float64)
    c = weights.make(shapes, 10, "cpu")
    assert all(torch.equal(a[k].double(), b[k]) for k in shapes)
    assert not torch.equal(a["decoder.output_mu.dense.0.weight"],
                           c["decoder.output_mu.dense.0.weight"])
    H = SMALL["lstm_hidden_dim"]
    bias = a["source_encoder.lstm.bias_0"]
    assert torch.equal(bias[H:2 * H], torch.ones(H))
    assert np.count_nonzero(bias.numpy()) == H
