"""The direct-window forecaster (`SeqVaeTebForecast(decoder_type="direct")`)
on the trainer's normal path, at a small size on the CPU (S=40, horizon
32, warmup 4, B=2: windows are kept at t = 4 .. 38): the program against
the plain float64 reference of the benchmark (`perfbench/reference/
forecast.py`, which imports neither JAX nor the port) on seeded random
weights, forward, losses and one step's gradients; `train_multi_step`
against K `train_step`s; the sliding-window NLL against its former
index-table form; each family's loss through the dispatch the trainer
calls against the family's own (SeqVaeTeb's `compute_loss`); and one tiny `cli train` run of the forecaster. Marked
`cuda`: a captured replay against its eager step on the card, and the
replay's launches (the encoders' cluster pair, the decoder's grid pair).
No JAX here: `python -m pytest tests/test_torch_forecast_train.py -m cuda`
runs on the card.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference.forecast import (ForecastModel, forecast_loss,
                                          param_shapes)
from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
from vae_teb_tpu_torch.models import (SeqVaeTebForecast, SeqVaeTebPredictSt,
                                      compute_loss)
from vae_teb_tpu_torch.models.variants import sliding_window_nll

torch.set_num_threads(2)

S, B, HORIZON, WARMUP, DEC = 40, 2, 32, 4, 16
ENC = dict(lstm_hidden_dim=8, lstm_num_layers=2)
FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")
# the reference's configuration: the program's encoders at ENC, the
# published decoder width (256), the small horizon and warmup
CFG = dict(input_channels=130, n_scattering=43, n_phase=44, latent_dim=32,
           seq_len=S, decimation_factor=DEC, hidden=256,
           prediction_horizon=HORIZON, warmup_period=WARMUP, **ENC)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(seed, b=B, s=S):
    return {"fhr_st": _x((b, s, 43), seed), "fhr_ph": _x((b, s, 44), seed + 1),
            "fhr_up_ph": _x((b, s, 130), seed + 2),
            "fhr": _x((b, DEC * s), seed + 3)}


def _model(seed=5, s=S, **enc):
    """The forecaster with the reference's seeded weights
    (`perfbench/weights.py`)."""
    model = SeqVaeTebForecast(decoder_type="direct",
                              prediction_horizon=HORIZON,
                              warmup_period=WARMUP, seq_len=s,
                              decimation_factor=DEC, **(enc or ENC))
    weights.fill(model.state_dict(), param_shapes(dict(CFG, seq_len=s,
                                                       **enc)), seed)
    return model


def test_reference_names_every_parameter():
    """The reference's parameter table is the program's state_dict, name
    for name and shape for shape, at the published widths too."""
    for cfg, enc in ((CFG, ENC), (dict(CFG, lstm_hidden_dim=64,
                                       lstm_num_layers=4,
                                       prediction_horizon=480), {})):
        model = SeqVaeTebForecast(
            prediction_horizon=cfg["prediction_horizon"], seq_len=S,
            **enc)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == dict(param_shapes(cfg))


def test_program_matches_reference():
    """One training-mode forward with the same noise, its losses and the
    gradients of every parameter, program (float32) against the float64
    reference. Bars, each from float32 rounding: outputs within 1e-4 of
    their largest entry (train-mode BatchNorm over 80 rows and the
    256-wide convs amplify rounding, as tests/test_torch_variants.py
    holds the decoders against JAX); the losses within rtol 1e-5 (a mean
    of 2 x 37 x 32 terms); each gradient leaf within 1e-4 of its largest
    entry or 1e-6 of the largest entry of any leaf (tests/test_torch_
    train.py's bar: a leaf whose gradient is near zero carries only
    rounding)."""
    model = _model().train()
    b = _batch(10)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    eps = torch.as_tensor(_x((B, S, 32), 99))
    out = model(t["fhr_st"], t["fhr_ph"], t["fhr_up_ph"], deterministic=False,
                eps=eps)
    got = model.loss(out, t["fhr_st"], t["fhr_ph"], t["fhr"], 0.3)
    got["total_loss"].backward()

    shapes = param_shapes(CFG)
    made = weights.make(shapes, 5, "cpu", dtype=torch.float64)
    P = {n: v.requires_grad_(not n.endswith(("running_mean", "running_var")))
         for n, v in made.items()}
    ref = ForecastModel(CFG, P, train=True)
    want_out = ref.forward(*(t[k].double() for k in FIELDS[:3]),
                           eps=eps.double())
    want = forecast_loss(want_out, t["fhr"].double(), 0.3, WARMUP, DEC)
    want["total_loss"].backward()

    for k in ("z", "window_mu", "window_logvar", "mu_prior", "mu_post",
              "logvar_post"):
        w = want_out[k].detach()
        err = (out[k].detach().double() - w).abs().max()
        assert err <= 1e-4 * w.abs().max(), k
    for k in ("nll_loss", "kld_loss", "total_loss"):
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-5,
                                   err_msg=k)
    named = dict(model.named_parameters())
    top = max(float(P[n].grad.abs().max()) for n in named)
    for n, p in named.items():
        w = P[n].grad
        err = float((p.grad.double() - w).abs().max())
        assert err <= max(1e-4 * float(w.abs().max()), 1e-6 * top), n


@pytest.mark.parametrize("s,h,length,warmup,dec", [
    (12, 32, 12 * 16 + 32, 3, 16),   # every step after warmup kept
    (20, 24, 200, 2, 8),             # the later steps overflow the signal
    (300, 480, 4800, 30, 16),        # the cell's: t = 30 .. 270
    (4, 8, 16, 10, 16),              # no step kept: 0
    (6, 40, 30, 0, 4)])              # a window longer than the signal: 0
def test_sliding_window_nll_matches_index_tables(s, h, length, warmup, dec):
    """The strided-view NLL equals the index-table gather it replaced (the
    steps t >= warmup whose window [t dec, t dec + h) fits the signal;
    the mean over the kept elements), bit for bit: the same elements in
    the same order through the same arithmetic."""
    mu, lv = torch.as_tensor(_x((2, s, h), 1)), \
        torch.as_tensor(0.3 * _x((2, s, h), 2))
    raw = torch.as_tensor(_x((2, length), 3))
    t_idx = np.arange(s)
    tv = t_idx[(t_idx >= warmup) & (t_idx * dec + h <= length)]
    got = sliding_window_nll(mu, lv, raw, warmup, dec)
    assert got.dtype == torch.float32
    if tv.size == 0:
        assert got.item() == 0.0
        return
    gather = torch.as_tensor(tv[:, None] * dec + np.arange(h)[None, :])
    tv = torch.as_tensor(tv)
    want = (0.5 * (lv[:, tv] + (raw[:, gather] - mu[:, tv]) ** 2
                   / torch.exp(lv[:, tv]))).mean()
    assert torch.equal(got, want)


def _family(name):
    """A seeded model of the family at S=8 and the loss it must give."""
    if name == "seqvae_teb":
        model = SeqVaeTeb(seq_len=8, **ENC)
        return model, lambda out, b, beta: compute_loss(
            out, b["fhr_st"], b["fhr_ph"], b["fhr"], beta=beta)
    if name == "forecast":
        model = SeqVaeTebForecast(prediction_horizon=16, warmup_period=2,
                                  seq_len=8, **ENC)
        return model, lambda out, b, beta: SeqVaeTebForecast.compute_loss(
            out, b["fhr"], beta, 2, 16)
    model = SeqVaeTebPredictSt(prediction_horizon=3, warmup_period=2,
                               seq_len=8, **ENC)
    return model, lambda out, b, beta: SeqVaeTebPredictSt.compute_loss(
        out, b["fhr_st"], b["fhr_ph"], beta, 2)


@pytest.mark.parametrize("name", ["seqvae_teb", "forecast", "predict_st"])
def test_family_loss_dispatch(name):
    """Each family's loss through the one signature the trainer calls
    (`model.loss(outputs, y_st, y_ph, y_raw, beta)`) is the family's own
    loss with the model's warmup and decimation, bit for bit, with beta a
    float or a 0-dim tensor as the trainer holds it: SeqVaeTeb's is
    `compute_loss`, unchanged."""
    model, want_of = _family(name)
    model = init_parameters(model, seed=1).train()
    b = {k: torch.as_tensor(v) for k, v in _batch(30, s=8).items()}
    out = model(b["fhr_st"], b["fhr_ph"], b["fhr_up_ph"], deterministic=False,
                generator=torch.Generator().manual_seed(1))
    for beta in (0.3, torch.tensor(1e-5)):
        got = model.loss(out, b["fhr_st"], b["fhr_ph"], b["fhr"], beta)
        want = want_of(out, b, beta)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in FIELDS}


def test_train_multi_step_equals_train_steps():
    """train_multi_step over a (3, B, ...) stack of forecaster steps on the
    CPU against three train_step calls from the same state: every metric
    (the forecaster's own loss terms) at every step and every parameter
    after are equal bit for bit; eval_step returns the same terms."""
    cfg = TrainerConfig(steps_per_execution=3, lr=1e-3)
    batches = [_batch(40 + 10 * i) for i in range(3)]
    single = Trainer(_model(), cfg, device="cpu")
    want = [single.train_step(b, 1e-5) for b in batches]
    multi = Trainer(_model(), cfg, device="cpu")
    got = multi.train_multi_step(_stack(batches), 1e-5)
    assert set(got) == {"nll_loss", "kld_loss", "reconstruction_loss",
                        "total_loss", "grad_norm"}
    for k in got:
        assert torch.equal(got[k], torch.stack([m[k] for m in want])), k
    for (n, a), b in zip(multi.model.state_dict().items(),
                         single.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert multi.step == 3
    ev = multi.eval_step(batches[0], 1e-5)
    assert set(ev) == set(got) - {"grad_norm"}
    assert all(torch.isfinite(v) for v in ev.values())


class _Arrays:
    """Arrays read as a dataset by PackedWindowStore.build."""

    def __init__(self, arrays):
        self.arrays, self.raw_layout = arrays, False
        self.stats, self.trim_minutes = None, None

    def __len__(self):
        return len(self.arrays["fhr"])

    def read_batch(self, indices):
        from vae_teb_tpu_torch.data import Batch
        idx = list(indices)
        return Batch({k: v[idx] for k, v in self.arrays.items()})


def test_cli_trains_the_forecaster(tmp_path, monkeypatch):
    """`cli train --device cpu` with `model: family: seqvae_teb_forecast`
    builds the forecaster from the run config (its warmup from it; the
    published horizon, 480 samples, so that S=36 keeps the windows of t =
    2 .. 6) and fits one epoch of two batches: a checkpoint of the
    forecaster's parameters, and a history of its own loss terms."""
    from vae_teb_tpu_torch.cli import main
    from vae_teb_tpu_torch.data import PackedWindowStore
    from vae_teb_tpu_torch.train import Checkpointer, RunConfig, save_config
    rows = [_batch(90 + i, b=2, s=36) for i in range(2)]
    arrays = {k: np.ascontiguousarray(np.concatenate([r[k] for r in rows]))
              for k in FIELDS}
    PackedWindowStore.build(_Arrays(arrays), str(tmp_path / "train"))
    cfg = RunConfig(tag="forecast", out_dir_base=str(tmp_path / "runs"))
    cfg.dataset.train_paths = [str(tmp_path / "train")]
    cfg.dataset.batch_size = 2
    cfg.trainer.epochs = 1
    cfg.trainer.lr = 1e-3
    cfg.model.family = "seqvae_teb_forecast"
    cfg.model.warmup_period = 2
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)
    built = []
    init = SeqVaeTebForecast.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    monkeypatch.setattr(SeqVaeTebForecast, "__init__", spy)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert main(["train", "--config", path, "--device", "cpu"]) == 0
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
        logging.getLogger("vae_teb_tpu_torch").handlers.clear()
    assert [(m.decoder_type, m.warmup_period) for m in built] == [
        ("direct", 2)]
    run_dir = cfg.run_dir(create=False)
    state = Checkpointer(os.path.join(run_dir, "model_checkpoints")).restore()
    assert state["step"] == 2
    assert any(k.startswith("window_decoder.") for k in state["model"])
    with open(os.path.join(run_dir, "train_results", "history.pkl"),
              "rb") as f:
        history = pickle.load(f)
    assert np.isfinite(history["train/nll_loss"]).all()
    assert history["train/nll_loss"][0] > 0
    assert "train/mse_loss" not in history


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's CUDA graph and the "
                    "wavefront kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_forecaster_matches_eager_on_card(cuda_device):
    """The forecaster at its published widths (encoders H=64 x 4, decoder
    LSTM(256) x 3, horizon 480, warmup 30) at S=300, B=32 on the card:
    four steps from one state, eagerly five times and as two groups of 2
    (the second group replays the captured step), held as
    tests/test_torch_capture.py holds SeqVaeTeb's (`_assert_like_eager`:
    the backward on the card is not deterministic, cuDNN's weight
    gradients adding atomically, so a replay is held within twice the
    spread of the eager runs, and the first step's losses exactly). Every
    replay launched the encoders' cluster pair and the decoder's grid pair
    once each, and the LayerNorm kernels once each way for each of the
    model's 121 LayerNorms."""
    from test_torch_capture import _assert_like_eager, _card_runs

    from vae_teb_tpu_torch.kernels import launch_counts
    s = 300
    model = SeqVaeTebForecast(seq_len=s)
    weights.fill(model.state_dict(), param_shapes(dict(
        CFG, seq_len=s, lstm_hidden_dim=64, lstm_num_layers=4,
        prediction_horizon=480, warmup_period=30)), 7)
    batches = [{k: torch.as_tensor(v, device=cuda_device)
                for k, v in _batch(200 + 10 * i, b=32, s=s).items()}
               for i in range(4)]
    before = launch_counts()
    runs, trainer = _card_runs(cuda_device, model,
                               TrainerConfig(steps_per_execution=2, lr=1e-3),
                               batches)
    launched = launch_counts() - before
    _assert_like_eager(runs)
    assert runs["C"]["metric.nll_loss"].gt(0).all()
    (graph,) = trainer.graphs.values()
    assert graph.replays == 2
    assert graph.launches == {
        ("wavefront_fwd", "wavefront_fwd_res_f32"): 1,
        ("wavefront_bwd", "wavefront_bwd_f32"): 1,
        ("wavefront_fwd", "wavefront_grid_fwd_res_f32"): 1,
        ("wavefront_bwd", "wavefront_grid_bwd_f32"): 1,
        ("wavefront_fwd", "residual_launches"): 2,
        ("wavefront_bwd", "launches"): 2,
        ("layer_norm_fwd", "layer_norm_fwd_f32"): 121,
        ("layer_norm_bwd", "layer_norm_bwd_f32"): 121,
        ("layer_norm_fwd", "launches"): 121,
        ("layer_norm_bwd", "launches"): 121}
    # 6 runs of 4 steps: every eager step and every replay
    assert launched[("wavefront_fwd", "wavefront_grid_fwd_res_f32")] == 24
    assert launched[("wavefront_bwd", "wavefront_grid_bwd_f32")] == 24
    assert launched[("layer_norm_bwd", "layer_norm_bwd_f32")] == 121 * 24
