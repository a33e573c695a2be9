"""SeqVaeTeb: sequence VAE with Target-Encoder-Bank conditioning.

Port of `vae_teb_tpu.models.vae_teb` (eval-mode forward, fp32). The
information flow is the JAX package's:

  SourceEncoder       x_ph (B,S,130) -> mu_x (B,S,32)          [causal]
  TargetEncoder       y_st (B,S,43), y_ph (B,S,44)
                      -> mu_y (B,S,32), logvar_full (B,S,64)
                      logvar_full splits into prior logvar + conditional feature
  ConditionalEncoder  (mu_x, c_logvar) -> q(z|x,y); mu_post += mu_y
  Decoder             z (B,S,32) -> linear_output (B,S,87),
                      raw mu/logvar (B, 16*S)

PyTorch modules need their input widths at construction, so the decoder's
two dense heads are sized from `seq_len` (300 in production: 4800-wide).
Every latent is LATENT_DIM wide and the decoder upsamples 16x (the JAX
defaults; no caller sets others). BatchNorm uses its running statistics:
this package serves; it does not train yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..kernels import wavefront_fwd
from .blocks import (LSTM, CausalConvBlock, ReflectConvBlock, ResidualMLP,
                     _layer_norm, geometric_schedule, gelu, run_lstm_streams)

LATENT_DIM = 32
UPSAMPLE = 16   # raw samples per latent step: 4 2x-upsampling conv blocks


# ---------------------------------------------------------------------------
# pure loss / divergence functions (fp32)
# ---------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def gaussian_kld(mu_prior, logvar_prior, mu_post, logvar_post,
                 reduce_mean: bool = True):
    """KL( N(mu_post, e^{logvar_post}) || N(mu_prior, e^{logvar_prior}) ),
    elementwise; reduce_mean sums the latent dim, then means over batch and
    time."""
    mu_prior, logvar_prior = _f32(mu_prior), _f32(logvar_prior)
    mu_post, logvar_post = _f32(mu_post), _f32(logvar_post)
    kld = 0.5 * (logvar_prior - logvar_post - 1.0
                 + (torch.exp(logvar_post) + (mu_post - mu_prior) ** 2)
                 / torch.exp(logvar_prior))
    if reduce_mean:
        return kld.sum(dim=-1).mean()
    return kld


def gaussian_nll(mu, logvar, target):
    """0.5 * (logvar + (target - mu)^2 / var), mean-reduced."""
    mu, logvar = _f32(mu), _f32(logvar)
    diff = _f32(target) - mu
    return (0.5 * (logvar + diff * diff / torch.exp(logvar))).mean()


def decoder_loss(linear_output, raw_mu, raw_logvar, y_st, y_ph, y_raw):
    """MSE on the coefficient reconstruction + NLL on the raw signal."""
    stacked_target = torch.cat([_f32(y_st), _f32(y_ph)], dim=-1)
    mse = torch.mean((_f32(linear_output) - stacked_target) ** 2)
    nll = gaussian_nll(raw_mu, raw_logvar, y_raw)
    return {"mse_loss": mse, "nll_loss": nll,
            "total_decoder_loss": mse + nll}


def compute_loss(outputs: Dict, y_st, y_ph, y_raw, beta: float = 1.0) -> Dict:
    """Reconstruction (MSE + NLL) + beta * KL(q || p)."""
    losses = decoder_loss(outputs["linear_output"], outputs["mu_pr"],
                          outputs["logvar_pr"], y_st, y_ph, y_raw)
    kld = gaussian_kld(outputs["mu_prior"], outputs["logvar_prior"],
                       outputs["mu_post"], outputs["logvar_post"])
    return {"reconstruction_loss": losses["total_decoder_loss"],
            "mse_loss": losses["mse_loss"], "nll_loss": losses["nll_loss"],
            "kld_loss": kld,
            "total_loss": losses["total_decoder_loss"] + beta * kld}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class TargetEncoder(nn.Module):
    """y_st + y_ph -> (mu, logvar_full): per-modality MLPs and causal convs,
    cross-modal fusion, LSTM, variational heads. Split into pre_lstm /
    post_lstm around the LSTM, which SeqVaeTeb.encode runs together with the
    source encoder's as one wavefront."""

    def __init__(self, lstm_hidden_dim: int = 64, lstm_num_layers: int = 4,
                 n_scattering: int = 43, n_phase: int = 44):
        super().__init__()
        H = lstm_hidden_dim
        self.mlp_scattering = ResidualMLP(
            n_scattering, geometric_schedule(n_scattering, 16, 4),
            final_activation=False, activation=gelu)
        self.mlp_phase = ResidualMLP(
            n_phase, geometric_schedule(n_phase, 16, 4),
            final_activation=False)
        self.conv_scattering_0 = CausalConvBlock(16, 16, 3)
        self.conv_scattering_1 = CausalConvBlock(16, 16, 5)
        self.conv_scattering_2 = CausalConvBlock(16, 16, 7)
        self.scatter_fused_norm = _layer_norm(16)
        self.conv_phase_0 = CausalConvBlock(16, 16, 3)
        self.conv_phase_1 = CausalConvBlock(16, 16, 5)
        self.conv_phase_2 = CausalConvBlock(16, 16, 7)
        self.phase_fused_norm = _layer_norm(16)
        self.cross_modal_fusion = ResidualMLP(
            32, geometric_schedule(32, 20, 5), final_activation=False)
        self.lstm = LSTM(20, H, lstm_num_layers)
        self.lstm_norm = _layer_norm(H)
        self.pre_output = ResidualMLP(H, geometric_schedule(H, 32, 5),
                                      final_activation=True)
        self.mu_layer = ResidualMLP(32, geometric_schedule(32, LATENT_DIM, 32),
                                    final_activation=False)
        self.logvar_layer = ResidualMLP(
            32, geometric_schedule(32, 2 * LATENT_DIM, 4),
            final_activation=False)

    def pre_lstm(self, y_st, y_ph):
        sc = self.mlp_scattering(y_st)
        ph = self.mlp_phase(y_ph)
        for conv in (self.conv_scattering_0, self.conv_scattering_1,
                     self.conv_scattering_2):
            sc = conv(sc)
        sc = self.scatter_fused_norm(sc)
        for conv in (self.conv_phase_0, self.conv_phase_1, self.conv_phase_2):
            ph = conv(ph)
        ph = self.phase_fused_norm(ph)
        return self.cross_modal_fusion(torch.cat([sc, ph], dim=-1))

    def post_lstm(self, x):
        x = self.pre_output(self.lstm_norm(x))
        mu = self.mu_layer(x)
        logvar = self.logvar_layer(x)
        return mu, torch.clamp(logvar, -10.0, 10.0)


SOURCE_CONV_KERNELS = (3, 5, 7)
SOURCE_CONV_WIDTH = 32


class SourceEncoder(nn.Module):
    """x_ph -> mu_x: MLP channel reduction, causal convs, causal LSTM
    (run by SeqVaeTeb.encode between pre_lstm and head)."""

    def __init__(self, input_channels: int = 130, lstm_hidden_dim: int = 64,
                 lstm_num_layers: int = 4):
        super().__init__()
        H, W = lstm_hidden_dim, SOURCE_CONV_WIDTH
        self.mlp = ResidualMLP(input_channels,
                               geometric_schedule(input_channels, W, 5),
                               final_activation=False)
        self.conv_0 = CausalConvBlock(W, W, SOURCE_CONV_KERNELS[0])
        self.conv_1 = CausalConvBlock(W, W, SOURCE_CONV_KERNELS[1])
        self.conv_2 = CausalConvBlock(W, W, SOURCE_CONV_KERNELS[2])
        self.fused_norm = _layer_norm(W)
        self.lstm = LSTM(W, H, lstm_num_layers)
        self.lstm_norm = _layer_norm(H)
        self.pre_output = ResidualMLP(H, geometric_schedule(H, 32, 4),
                                      final_activation=True)
        self.mu_layer = ResidualMLP(32, geometric_schedule(32, LATENT_DIM, 4),
                                    final_activation=False)

    def pre_lstm(self, x):
        x = self.mlp(x)
        for conv in (self.conv_0, self.conv_1, self.conv_2):
            x = conv(x)
        return self.fused_norm(x)

    def head(self, x):
        return self.mu_layer(self.pre_output(self.lstm_norm(x)))


class ConditionalEncoder(nn.Module):
    """q(z | x, y): concat(mu_x, c_logvar) -> ResidualMLP trunk -> mu and
    logvar heads. The geometric schedule over 8 hidden layers is split 5
    (trunk) + 3 (each head)."""

    def __init__(self):
        super().__init__()
        dims = geometric_schedule(2 * LATENT_DIM, LATENT_DIM, 8)
        self.mlp = ResidualMLP(2 * LATENT_DIM, dims[0:5], final_activation=True)
        self.fc_mu = ResidualMLP(dims[4], dims[5:], final_activation=False,
                                 use_skip_connection=False)
        self.fc_logvar = ResidualMLP(dims[4], dims[5:], final_activation=False,
                                     use_skip_connection=False)

    def forward(self, h_x, h_y):
        h = self.mlp(torch.cat([h_x, h_y], dim=-1))
        return self.fc_mu(h), self.fc_logvar(h)


# (features, kernel, 2x upsample?) of the decoder's reflect-conv ladder
DECODER_CONV_SPEC = ((77, 11, False), (66, 9, True), (55, 7, True),
                     (44, 5, False), (33, 5, True), (22, 3, True),
                     (11, 3, False), (1, 3, False))


class Decoder(nn.Module):
    """z (B,S,latent) -> (linear_output (B,S,coeff), raw mu/logvar
    (B, 16*S)): MLP trunk, 8 reflect-conv blocks with 4 2x-upsample stages,
    two dense heads of width 16*seq_len."""

    def __init__(self, coeff_channels: int = 87, seq_len: int = 300):
        super().__init__()
        self.raw_len = seq_len * UPSAMPLE
        self.linear_0 = ResidualMLP(LATENT_DIM,
                                    geometric_schedule(LATENT_DIM, 50, 5),
                                    final_activation=True)
        self.linear_1 = ResidualMLP(50, geometric_schedule(50, coeff_channels, 5),
                                    final_activation=True)
        in_features = coeff_channels
        for i, (feat, k, up) in enumerate(DECODER_CONV_SPEC):
            self.add_module(f"conv_{i}", ReflectConvBlock(in_features, feat, k,
                                                          up_sampling=up))
            in_features = feat
        self.output_mu = ResidualMLP(self.raw_len, (self.raw_len,) * 2,
                                     final_activation=False,
                                     use_skip_connection=False)
        self.output_logvar = ResidualMLP(self.raw_len, (self.raw_len,) * 2,
                                         final_activation=False,
                                         use_skip_connection=False)

    def forward(self, z):
        linear_output = self.linear_1(self.linear_0(z))
        x = linear_output
        for i in range(len(DECODER_CONV_SPEC)):
            x = getattr(self, f"conv_{i}")(x)
        x = x.reshape(x.shape[0], -1)
        if x.shape[1] != self.raw_len:
            raise ValueError(f"decoder built for raw length {self.raw_len}, "
                             f"got {x.shape[1]}")
        return linear_output, self.output_mu(x), self.output_logvar(x)


class SeqVaeTeb(nn.Module):
    """Full TEB sequence VAE, eval mode.

    The attribute `recurrence` is the forward wavefront recurrence both
    encoder LSTMs run through: `kernels.wavefront_fwd`, which dispatches by
    device (CUDA kernel, or plain PyTorch on the CPU). A caller may swap in
    `kernels.wavefront_fwd_plain` to compare the two on the card.
    """

    def __init__(self, input_channels: int = 130, n_scattering: int = 43,
                 n_phase: int = 44, lstm_hidden_dim: int = 64,
                 lstm_num_layers: int = 4, seq_len: int = 300):
        super().__init__()
        self.recurrence: Callable = wavefront_fwd
        self.source_encoder = SourceEncoder(input_channels, lstm_hidden_dim,
                                            lstm_num_layers)
        self.target_encoder = TargetEncoder(lstm_hidden_dim, lstm_num_layers,
                                            n_scattering, n_phase)
        self.conditional_encoder = ConditionalEncoder()
        self.decoder = Decoder(n_scattering + n_phase, seq_len)

    def encode(self, y_st, y_ph, x_ph) -> Dict[str, torch.Tensor]:
        """All three encoders; the two LSTMs run as one wavefront."""
        se, te = self.source_encoder, self.target_encoder
        se_stream = se.lstm(se.pre_lstm(x_ph))
        te_stream = te.lstm(te.pre_lstm(y_st, y_ph))
        (se_out, _), (te_out, _) = run_lstm_streams(
            [se_stream, te_stream], recurrence=self.recurrence)
        mu_x = se.head(se_out)
        mu_y, logvar_full = te.post_lstm(te_out)
        logvar_prior, c_logvar = logvar_full.chunk(2, dim=-1)
        mu_post, logvar_post = self.conditional_encoder(mu_x, c_logvar)
        mu_post = mu_post + mu_y  # residual posterior mean
        return {"mu_x": mu_x, "mu_prior": mu_y, "logvar_prior": logvar_prior,
                "mu_post": mu_post, "logvar_post": logvar_post}

    def forward(self, y_st, y_ph, x_ph, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """deterministic=True decodes the posterior mean; otherwise z is
        sampled with noise from `generator` (required, on the inputs'
        device)."""
        enc = self.encode(y_st, y_ph, x_ph)
        mu, logvar = enc["mu_post"], enc["logvar_post"]
        if deterministic:
            z = mu
        else:
            if generator is None:
                raise ValueError("sampling needs an explicit torch.Generator")
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=mu.device)
            z = mu + eps * torch.exp(0.5 * logvar)
        linear_output, mu_pr, logvar_pr = self.decoder(z)
        return {"z": z, "linear_output": linear_output,
                "mu_pr": mu_pr, "logvar_pr": logvar_pr, **enc}

    def measure_transfer_entropy(self, y_st, y_ph, x_ph):
        """TE(source -> latent) = KL(q(z|x,y) || p(z|y)) per step and dim."""
        enc = self.encode(y_st, y_ph, x_ph)
        return gaussian_kld(enc["mu_prior"], enc["logvar_prior"],
                            enc["mu_post"], enc["logvar_post"],
                            reduce_mean=False)
