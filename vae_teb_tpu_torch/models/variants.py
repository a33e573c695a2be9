"""Forecasting decoder variants, the predict-st model family and the LDAM
loss.

Port of `vae_teb_tpu.models.variants`:

  DirectWindowDecoder   per-timestep future raw windows from three paths
                        (MLP, a 3-layer LSTM(256), six causal convs)
                        summed, then window heads
  ConvWindowDecoder     per-timestep (16, 30) maps through a shared
                        upsampling reflect-conv stack over B * S rows, then
                        window heads
  PredictStDecoder      future scattering and phase coefficient windows
                        (B, S, H, C): MLP and dilated causal TCN, a 2-layer
                        LSTM(256), per-modality dense heads

and `SeqVaeTebForecast` / `SeqVaeTebPredictSt`, SeqVaeTeb's encoders with
one of these decoders in place of the raw `Decoder` (which they do not
carry: flax never creates its parameters there). The decoders' LSTMs are
4H = 1024 wide, which no thread-block cluster takes: on the card they run
on the grid kernels (`kernels/wavefront_grid_*.cu`), one launch per
forward and one per backward, beside the encoders' cluster launch.

The losses run their arithmetic in float32. The sliding-window NLL takes
its windows as a strided view of the raw signal (`unfold`), with no index
table; the coefficient windows of predict-st are gathered with a static
index table built in numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import wavefront_recurrence
from ..utils import profiling
from .blocks import (LSTM, CausalConvBlock, Dense, Dtype, ReflectConvBlock,
                     ResidualMLP, geometric_schedule, gelu, run_lstm_streams)
from .vae_teb import LATENT_DIM, SeqVaeTeb, _f32, gaussian_kld, sample_z


# ---------------------------------------------------------------------------
# sliding-window losses
# ---------------------------------------------------------------------------

def _index(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def sliding_window_nll(mu: torch.Tensor, logvar: torch.Tensor,
                       target_raw: torch.Tensor, warmup_period: int = 30,
                       decimation_factor: int = 16) -> torch.Tensor:
    """Gaussian NLL of per-timestep future windows against the raw signal.

    mu/logvar: (B, S, H); target_raw: (B, L). Step t predicts raw samples
    [t*dec, t*dec + H); steps before warmup or overflowing L are skipped,
    and the NLL is the mean over every kept (batch, step, sample). 0 when
    no step is kept. The windows are a strided view of the signal
    (`unfold`) and the kept steps a slice: no index table, so nothing is
    copied from the host and a CUDA graph of a train step holds it.
    """
    s, h = mu.shape[1], mu.shape[2]
    length = target_raw.shape[1]
    t0 = max(warmup_period, 0)
    t1 = min(s, (length - h) // decimation_factor + 1) if length >= h else 0
    if t1 <= t0:
        return torch.zeros((), dtype=torch.float32, device=mu.device)
    windows = _f32(target_raw).unfold(1, h, decimation_factor)[:, t0:t1]
    mu_v = _f32(mu)[:, t0:t1]
    lv_v = _f32(logvar)[:, t0:t1]
    nll = 0.5 * (lv_v + (windows - mu_v) ** 2 / torch.exp(lv_v))
    return nll.mean()


def future_window_targets(target: torch.Tensor, horizon: int) -> torch.Tensor:
    """(B, S, C) -> (B, S-H, H, C): the window at t holds steps t+1 .. t+H."""
    s = target.shape[1]
    t = np.arange(s - horizon)[:, None] + np.arange(1, horizon + 1)[None, :]
    return target[:, _index(t, target)]


def predict_st_loss(predictions: Dict[str, torch.Tensor],
                    target_scattering: torch.Tensor,
                    target_phase: torch.Tensor, warmup_period: int,
                    compute_scattering_loss: bool = True,
                    compute_phase_loss: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """Gaussian NLL over the future coefficient windows of both modalities,
    over the steps [warmup_period, S - H); all zeros when that range is
    empty."""
    s = target_scattering.shape[1]
    horizon = predictions["scattering_mu"].shape[2]
    start, end = warmup_period, s - horizon
    zero = torch.zeros((), dtype=torch.float32,
                       device=target_scattering.device)
    if start >= end:
        return {"total_loss": zero, "scattering_loss": zero,
                "phase_loss": zero}

    def _nll(mu, logvar, windows):
        mu, logvar, windows = _f32(mu), _f32(logvar), _f32(windows)
        return (0.5 * (logvar + (windows - mu) ** 2 / torch.exp(logvar))
                ).mean()

    scattering_loss = phase_loss = zero
    if compute_scattering_loss:
        win = future_window_targets(target_scattering, horizon)[:, start:end]
        scattering_loss = _nll(predictions["scattering_mu"][:, start:end],
                               predictions["scattering_logvar"][:, start:end],
                               win)
    if compute_phase_loss:
        win = future_window_targets(target_phase, horizon)[:, start:end]
        phase_loss = _nll(predictions["phase_harmonic_mu"][:, start:end],
                          predictions["phase_harmonic_logvar"][:, start:end],
                          win)
    return {"total_loss": scattering_loss + phase_loss,
            "scattering_loss": scattering_loss, "phase_loss": phase_loss}


def ldam_loss(logits: torch.Tensor, labels: torch.Tensor,
              cls_num_list: Sequence[int], max_m: float = 0.5,
              s: float = 30.0) -> torch.Tensor:
    """Label-Distribution-Aware Margin loss: the true-class logit less a
    class margin proportional to n_j^(-1/4) (the largest max_m), scaled by
    s, then cross-entropy."""
    counts = np.asarray(cls_num_list, dtype=np.float64)
    margins = 1.0 / np.sqrt(np.sqrt(counts))
    margins = margins * (max_m / margins.max())
    labels = labels.long()
    m = torch.as_tensor(margins, dtype=torch.float32,
                        device=logits.device)[labels]
    onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    logp = torch.log_softmax(s * (logits - onehot * m[:, None]), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

DIRECT_CONV_KERNELS = (3, 5, 7, 11, 19, 29)


class DirectWindowDecoder(nn.Module):
    """z -> per-timestep (mu, logvar) of the future raw window: an MLP, a
    3-layer LSTM(hidden) and six causal convs (k = 3 .. 29) in parallel,
    summed, then a processor MLP and the window heads; logvar clipped to
    [-8, 8]. Stage marks (`utils.profiling`): `window_paths` once the
    three paths are summed, `window_heads` once both heads have run."""

    def __init__(self, latent_dim: int = LATENT_DIM,
                 prediction_horizon: int = 480, hidden: int = 256,
                 dtype: Dtype = None):
        super().__init__()
        self.linear = ResidualMLP(latent_dim,
                                  geometric_schedule(latent_dim, hidden, 4),
                                  final_activation=True, dtype=dtype)
        self.lstm = LSTM(latent_dim, hidden, 3, dtype)
        in_features = latent_dim
        for i, k in enumerate(DIRECT_CONV_KERNELS):
            self.add_module(f"conv_{i}", CausalConvBlock(in_features, hidden,
                                                         k, dtype))
            in_features = hidden
        self.final_processor = ResidualMLP(
            hidden, geometric_schedule(hidden, 360, 4), final_activation=True,
            dtype=dtype)
        head = lambda: ResidualMLP(
            360, geometric_schedule(360, prediction_horizon, 5),
            final_activation=False, use_skip_connection=False, dtype=dtype)
        self.output_mu = head()
        self.output_logvar = head()

    def forward(self, z: torch.Tensor,
                recurrence: Callable = wavefront_recurrence):
        ((x_lstm, _),) = run_lstm_streams([self.lstm(z)], recurrence)
        x_conv = z
        for i in range(len(DIRECT_CONV_KERNELS)):
            x_conv = getattr(self, f"conv_{i}")(x_conv)
        x = self.linear(z) + x_lstm + x_conv
        profiling.mark("window_paths")
        x = self.final_processor(x)
        mu, logvar = self.output_mu(x), self.output_logvar(x)
        profiling.mark("window_heads")
        return mu, torch.clamp(logvar, -8.0, 8.0)


# (features, kernel, 2x upsample) of the conv-window decoder's shared stack
CONV_WINDOW_SPEC = ((32, 11, False), (32, 9, True), (24, 7, True),
                    (16, 5, True), (8, 3, True), (1, 3, False))


class ConvWindowDecoder(nn.Module):
    """z -> per-timestep (feature_channels, feature_len) maps -> a shared
    reflect-conv stack (4 2x upsamplings: feature_len -> 16 feature_len)
    over the B * S maps -> window heads; logvar clipped to [-8, 8]."""

    def __init__(self, latent_dim: int = LATENT_DIM,
                 prediction_horizon: int = 480, feature_channels: int = 16,
                 feature_len: int = 30, dtype: Dtype = None):
        super().__init__()
        self.feature_channels = feature_channels
        self.feature_len = feature_len
        fdim = feature_channels * feature_len
        self.linear_0 = ResidualMLP(latent_dim,
                                    geometric_schedule(latent_dim, 50, 5),
                                    final_activation=True, dtype=dtype)
        self.linear_1 = ResidualMLP(50, geometric_schedule(50, fdim, 5),
                                    final_activation=True, dtype=dtype)
        in_features = feature_channels
        for i, (feat, k, up) in enumerate(CONV_WINDOW_SPEC):
            self.add_module(f"conv_{i}", ReflectConvBlock(
                in_features, feat, k, up_sampling=up, dtype=dtype))
            in_features = feat
        h = prediction_horizon
        self.pre_output = ResidualMLP(feature_len * 16, (h, h),
                                      final_activation=False,
                                      use_skip_connection=False, dtype=dtype)
        head = lambda: ResidualMLP(h, (h,) * 3, final_activation=False,
                                   use_skip_connection=False, dtype=dtype)
        self.output_mu = head()
        self.output_logvar = head()

    def forward(self, z: torch.Tensor,
                recurrence: Callable = wavefront_recurrence):
        b, s, _ = z.shape
        x = self.linear_1(self.linear_0(z))
        x = x.reshape(b * s, self.feature_len, self.feature_channels)
        for i in range(len(CONV_WINDOW_SPEC)):
            x = getattr(self, f"conv_{i}")(x)
        x = self.pre_output(x.reshape(b, s, self.feature_len * 16))
        return (self.output_mu(x),
                torch.clamp(self.output_logvar(x), -8.0, 8.0))


TCN_LAYERS = ((3, 1), (3, 2), (3, 4), (3, 8))   # (kernel, dilation)


class PredictStDecoder(nn.Module):
    """z -> future scattering and phase coefficient windows
    {scattering_mu, scattering_logvar, phase_harmonic_mu,
    phase_harmonic_logvar}, each (B, S, H, C_mod): a gelu MLP and a dilated
    causal TCN (d = 1, 2, 4, 8) fused, an LSTM(hidden, lstm_layers), a gelu
    MLP, then per-modality dense heads; logvar clipped to [-10, 10]."""

    def __init__(self, latent_dim: int = LATENT_DIM,
                 prediction_horizon: int = 30, scattering_channels: int = 43,
                 phase_channels: int = 44, hidden: int = 256,
                 lstm_layers: int = 2, dtype: Dtype = None):
        super().__init__()
        self.horizon = prediction_horizon
        self.channels = (("scattering", scattering_channels),
                         ("phase_harmonic", phase_channels))
        self.linear_path = ResidualMLP(
            latent_dim, geometric_schedule(latent_dim, hidden, 4),
            final_activation=True, activation=gelu, dtype=dtype)
        in_features = latent_dim
        for i, (k, d) in enumerate(TCN_LAYERS):
            self.add_module(f"tcn_{i}", CausalConvBlock(
                in_features, hidden, k, dtype, dilation=d))
            in_features = hidden
        self.path_fusion = ResidualMLP(2 * hidden, (hidden, hidden),
                                       final_activation=True,
                                       activation=gelu, dtype=dtype)
        self.lstm = LSTM(hidden, hidden, lstm_layers, dtype)
        self.post_lstm = ResidualMLP(hidden, (hidden, hidden),
                                     final_activation=True, activation=gelu,
                                     dtype=dtype)
        for mod, c in self.channels:
            self.add_module(f"{mod}_mu_head",
                            Dense(hidden, prediction_horizon * c, dtype=dtype))
            self.add_module(f"{mod}_logvar_head",
                            Dense(hidden, prediction_horizon * c, dtype=dtype))

    def forward(self, z: torch.Tensor,
                recurrence: Callable = wavefront_recurrence
                ) -> Dict[str, torch.Tensor]:
        b, s, _ = z.shape
        conv = z
        for i in range(len(TCN_LAYERS)):
            conv = getattr(self, f"tcn_{i}")(conv)
        x = self.path_fusion(torch.cat([self.linear_path(z), conv], dim=-1))
        ((x, _),) = run_lstm_streams([self.lstm(x)], recurrence)
        x = self.post_lstm(x)
        out = {}
        for mod, c in self.channels:
            mu = getattr(self, f"{mod}_mu_head")(x)
            lv = getattr(self, f"{mod}_logvar_head")(x)
            out[f"{mod}_mu"] = mu.reshape(b, s, self.horizon, c)
            out[f"{mod}_logvar"] = torch.clamp(
                lv.reshape(b, s, self.horizon, c), -10.0, 10.0)
        return out


# ---------------------------------------------------------------------------
# the model families (SeqVaeTeb's encoders)
# ---------------------------------------------------------------------------

class SeqVaeTebForecast(SeqVaeTeb):
    """SeqVaeTeb with a future-window forecaster in place of the decoder:
    decoder_type "direct" (DirectWindowDecoder) or "conv_window"
    (ConvWindowDecoder). Loss (`loss`): sliding-window NLL over the steps
    from `warmup_period` on, each step's window `decimation_factor` raw
    samples after the last, + beta * KL. Other arguments as SeqVaeTeb's
    (`seq_len` sizes nothing here)."""

    raw_decoder = False

    def __init__(self, decoder_type: str = "direct",
                 prediction_horizon: int = 480, warmup_period: int = 30,
                 **kwargs):
        super().__init__(**kwargs)
        self.decoder_type = decoder_type
        self.warmup_period = warmup_period
        if decoder_type == "direct":
            self.window_decoder = DirectWindowDecoder(
                self.latent_dim_z, prediction_horizon, dtype=self.dtype)
        elif decoder_type == "conv_window":
            self.window_decoder = ConvWindowDecoder(
                self.latent_dim_z, prediction_horizon, dtype=self.dtype)
        else:
            raise ValueError(f"unknown decoder_type {decoder_type}")

    def forward(self, y_st, y_ph, x_ph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """As SeqVaeTeb.forward, with the window decoder: {z, window_mu,
        window_logvar (B, S, H), and the encodings}. Spans and stage marks
        as SeqVaeTeb.forward's (`model.encode`, `model.decode`; `encode`,
        `decode`, `decode_backward`), and the direct decoder's own
        (`window_paths`, `window_heads`)."""
        with profiling.span("model.encode"):
            enc = self.encode(y_st, y_ph, x_ph)
            z = sample_z(enc, deterministic, generator, eps)
            profiling.mark("encode")
            profiling.mark_on_grad(z, "decode_backward")
        with profiling.span("model.decode"):
            mu_w, logvar_w = self.window_decoder(z, self.recurrence)
            profiling.mark("decode")
        return {"z": z, "window_mu": mu_w, "window_logvar": logvar_w, **enc}

    def loss(self, outputs: Dict, y_st, y_ph, y_raw, beta) -> Dict:
        """The training loss `train.Trainer` calls: `compute_loss` with the
        model's warmup and decimation."""
        return self.compute_loss(outputs, y_raw, beta, self.warmup_period,
                                 self.decimation_factor)

    @staticmethod
    def compute_loss(outputs: Dict, y_raw, beta: float = 1.0,
                     warmup_period: int = 30,
                     decimation_factor: int = 16) -> Dict:
        nll = sliding_window_nll(outputs["window_mu"],
                                 outputs["window_logvar"], y_raw,
                                 warmup_period, decimation_factor)
        kld = gaussian_kld(outputs["mu_prior"], outputs["logvar_prior"],
                           outputs["mu_post"], outputs["logvar_post"])
        return {"nll_loss": nll, "kld_loss": kld,
                "reconstruction_loss": nll, "total_loss": nll + beta * kld}


class SeqVaeTebPredictSt(SeqVaeTeb):
    """SeqVaeTeb predicting future scattering and phase coefficients
    (PredictStDecoder) instead of the raw signal; its loss (`loss`) skips
    the steps before `warmup_period`. Other arguments as SeqVaeTeb's."""

    raw_decoder = False

    def __init__(self, prediction_horizon: int = 30, warmup_period: int = 30,
                 **kwargs):
        super().__init__(**kwargs)
        self.warmup_period = warmup_period
        self.st_decoder = PredictStDecoder(
            self.latent_dim_z, prediction_horizon, self.n_scattering,
            self.n_phase, dtype=self.dtype)

    def forward(self, y_st, y_ph, x_ph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """As SeqVaeTeb.forward, with the coefficient-window decoder: {z,
        the four PredictStDecoder outputs, and the encodings}."""
        enc = self.encode(y_st, y_ph, x_ph)
        z = sample_z(enc, deterministic, generator, eps)
        return {"z": z, **self.st_decoder(z, self.recurrence), **enc}

    def loss(self, outputs: Dict, y_st, y_ph, y_raw, beta) -> Dict:
        """The training loss `train.Trainer` calls: `compute_loss` with the
        model's warmup."""
        return self.compute_loss(outputs, y_st, y_ph, beta,
                                 self.warmup_period)

    @staticmethod
    def compute_loss(outputs: Dict, y_st, y_ph, beta: float = 1.0,
                     warmup_period: int = 30) -> Dict:
        losses = predict_st_loss(outputs, y_st, y_ph, warmup_period)
        kld = gaussian_kld(outputs["mu_prior"], outputs["logvar_prior"],
                           outputs["mu_post"], outputs["logvar_post"])
        return {**losses, "kld_loss": kld,
                "total_loss": losses["total_loss"] + beta * kld,
                "reconstruction_loss": losses["total_loss"]}
