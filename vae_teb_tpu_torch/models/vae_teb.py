"""SeqVaeTeb: sequence VAE with Target-Encoder-Bank conditioning.

Port of `vae_teb_tpu.models.vae_teb`. The information flow is the JAX
package's:

  SourceEncoder       x_ph (B,S,130) -> mu_x (B,S,32)          [causal]
  TargetEncoder       y_st (B,S,43), y_ph (B,S,44)
                      -> mu_y (B,S,32), logvar_full (B,S,64)
                      logvar_full splits into prior logvar + conditional feature
  ConditionalEncoder  (mu_x, c_logvar) -> q(z|x,y); mu_post += mu_y
  Decoder             z (B,S,32) -> linear_output (B,S,87),
                      raw mu/logvar (B, 16*S)

PyTorch modules need their input widths at construction, so the decoder's
two dense heads are sized from `seq_len` times the decimation factor (300
x 16 in production: 4800-wide). The three latent widths (source, target,
z) and the decimation factor (a power of two up to 16) are the JAX
model's fields, with its defaults (LATENT_DIM, UPSAMPLE); `decode(z)` runs
the decoder alone. The source encoder is causal end to end, so
`encode_source_stream` encodes it chunk by chunk from a carried state
(`source_stream_init_state`: the causal convs' input tails and the LSTM's
h and c) and chained chunks give the full-sequence encoding. The module's mode is flax's `train`
flag: in training mode (`model.train()`) BatchNorm normalizes with batch
statistics and updates its running averages; in eval mode it uses the
running averages. Sampling of z is a separate switch (`deterministic`), as
in the JAX package.

`dtype` is the compute precision policy (`SeqVaeTeb(dtype=torch.bfloat16)`,
the JAX package's `SeqVaeTeb(dtype=jnp.bfloat16)`): parameters stay float32,
every layer computes in `dtype` (see `blocks`), the noise of z is drawn in
it and z formed in it, and the loss functions cast back to float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..kernels import wavefront_recurrence
from ..parallel.collectives import draw, local_rows
from ..utils import profiling
from .blocks import (LSTM, CausalConvBlock, Dtype, LayerNorm,
                     ReflectConvBlock, ResidualMLP, geometric_schedule, gelu,
                     run_lstm_streams)

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


def compute_loss(outputs: Dict, y_st, y_ph, y_raw, beta: float = 1.0,
                 compute_kld_loss: bool = True) -> Dict:
    """Reconstruction (MSE + NLL) + beta * KL(q || p); the KL term is 0
    when compute_kld_loss is False."""
    losses = decoder_loss(outputs["linear_output"], outputs["mu_pr"],
                          outputs["logvar_pr"], y_st, y_ph, y_raw)
    if compute_kld_loss:
        kld = gaussian_kld(outputs["mu_prior"], outputs["logvar_prior"],
                           outputs["mu_post"], outputs["logvar_post"])
    else:
        kld = torch.zeros((), dtype=torch.float32,
                          device=losses["total_decoder_loss"].device)
    return {"reconstruction_loss": losses["total_decoder_loss"],
            "mse_loss": losses["mse_loss"], "nll_loss": losses["nll_loss"],
            "kld_loss": kld,
            "total_loss": losses["total_decoder_loss"] + beta * kld}


def stitch_predictions(x: torch.Tensor, stride: int = 16,
                       new_len: int = 4800
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlap-average per-step windows onto the raw-signal grid.

    x: (B, N, C) per-step length-C predictions placed at offsets i*stride.
    Returns (stacked (B, K, new_len) with NaN where nothing lands, their
    NaN-mean (B, new_len), 0 where nothing lands), K = ceil(C / stride):
    output position j receives step i = j // stride - k at column
    j % stride + stride * k, for k < K.
    """
    b, n, c = x.shape
    k_max = (c + stride - 1) // stride
    j = np.arange(new_len)
    ks = np.arange(k_max)[:, None]
    i_idx = j[None, :] // stride - ks                      # (K, new_len)
    c_idx = j[None, :] % stride + stride * ks
    valid = (i_idx >= 0) & (i_idx < n) & (c_idx < c)
    index = lambda a: torch.as_tensor(a, device=x.device)
    vals = x[:, index(np.clip(i_idx, 0, n - 1)), index(np.clip(c_idx, 0, c - 1))]
    mask = index(valid)[None]
    stacked = torch.where(mask, vals, torch.nan)
    mean = torch.where(mask, vals, 0.0).sum(1) / mask.sum(1).clamp_min(1)
    return stacked, mean


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class TargetEncoder(nn.Module):
    """y_st + y_ph -> (mu, logvar_full): per-modality MLPs and causal convs,
    cross-modal fusion, LSTM, variational heads. Split into pre_lstm /
    post_lstm around the LSTM, which SeqVaeTeb.encode runs together with the
    source encoder's as one wavefront."""

    def __init__(self, lstm_hidden_dim: int = 64, lstm_num_layers: int = 4,
                 n_scattering: int = 43, n_phase: int = 44,
                 dtype: Dtype = None, latent_dim: int = LATENT_DIM):
        super().__init__()
        H, dt = lstm_hidden_dim, dtype
        self.mlp_scattering = ResidualMLP(
            n_scattering, geometric_schedule(n_scattering, 16, 4),
            final_activation=False, activation=gelu, dtype=dt)
        self.mlp_phase = ResidualMLP(
            n_phase, geometric_schedule(n_phase, 16, 4),
            final_activation=False, dtype=dt)
        self.conv_scattering_0 = CausalConvBlock(16, 16, 3, dt)
        self.conv_scattering_1 = CausalConvBlock(16, 16, 5, dt)
        self.conv_scattering_2 = CausalConvBlock(16, 16, 7, dt)
        self.scatter_fused_norm = LayerNorm(16, dt)
        self.conv_phase_0 = CausalConvBlock(16, 16, 3, dt)
        self.conv_phase_1 = CausalConvBlock(16, 16, 5, dt)
        self.conv_phase_2 = CausalConvBlock(16, 16, 7, dt)
        self.phase_fused_norm = LayerNorm(16, dt)
        self.cross_modal_fusion = ResidualMLP(
            32, geometric_schedule(32, 20, 5), final_activation=False,
            dtype=dt)
        self.lstm = LSTM(20, H, lstm_num_layers, dt)
        self.lstm_norm = LayerNorm(H, dt)
        self.pre_output = ResidualMLP(H, geometric_schedule(H, 32, 5),
                                      final_activation=True, dtype=dt)
        self.mu_layer = ResidualMLP(32, geometric_schedule(32, latent_dim, 32),
                                    final_activation=False, dtype=dt)
        self.logvar_layer = ResidualMLP(
            32, geometric_schedule(32, 2 * latent_dim, 4),
            final_activation=False, dtype=dt)

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

    def forward(self, y_st, y_ph,
                recurrence: Callable = wavefront_recurrence):
        """The encoder alone, its LSTM as one wavefront through
        `recurrence`: (mu, logvar_full)."""
        ((x, _),) = run_lstm_streams([self.lstm(self.pre_lstm(y_st, y_ph))],
                                     recurrence)
        return self.post_lstm(x)


SOURCE_CONV_KERNELS = (3, 5, 7)
SOURCE_CONV_WIDTH = 32


def source_stream_init_state(batch_size: int, lstm_num_layers: int = 4,
                             lstm_hidden_dim: int = 64, dtype: Dtype = None,
                             device=None) -> Dict:
    """The zero state `SourceEncoder.stream` starts from, on `device`:
    {"conv_tails": one (B, k-1, 32) tail per causal conv (the zero left pad
    of a full-sequence call), "h", "c": the LSTM's (num_layers, B, H)}, in
    the compute dtype (float32 when None)."""
    dt = dtype or torch.float32
    tails = tuple(torch.zeros((batch_size, k - 1, SOURCE_CONV_WIDTH),
                              dtype=dt, device=device)
                  for k in SOURCE_CONV_KERNELS)
    h = torch.zeros((lstm_num_layers, batch_size, lstm_hidden_dim), dtype=dt,
                    device=device)
    return {"conv_tails": tails, "h": h, "c": torch.zeros_like(h)}


class SourceEncoder(nn.Module):
    """x_ph -> mu_x: MLP channel reduction, causal convs, causal LSTM
    (run by SeqVaeTeb.encode between pre_lstm and head, or alone by
    `forward` and `stream`). Everything is causal: the encoding at step t
    sees only x[<= t], which is what makes `stream` possible."""

    def __init__(self, input_channels: int = 130, lstm_hidden_dim: int = 64,
                 lstm_num_layers: int = 4, dtype: Dtype = None,
                 latent_dim: int = LATENT_DIM):
        super().__init__()
        H, W, dt = lstm_hidden_dim, SOURCE_CONV_WIDTH, dtype
        self.mlp = ResidualMLP(input_channels,
                               geometric_schedule(input_channels, W, 5),
                               final_activation=False, dtype=dt)
        self.conv_0 = CausalConvBlock(W, W, SOURCE_CONV_KERNELS[0], dt)
        self.conv_1 = CausalConvBlock(W, W, SOURCE_CONV_KERNELS[1], dt)
        self.conv_2 = CausalConvBlock(W, W, SOURCE_CONV_KERNELS[2], dt)
        self.fused_norm = LayerNorm(W, dt)
        self.lstm = LSTM(W, H, lstm_num_layers, dt)
        self.lstm_norm = LayerNorm(H, dt)
        self.pre_output = ResidualMLP(H, geometric_schedule(H, 32, 4),
                                      final_activation=True, dtype=dt)
        self.mu_layer = ResidualMLP(32, geometric_schedule(32, latent_dim, 4),
                                    final_activation=False, dtype=dt)

    def pre_lstm(self, x, conv_tails: Optional[Tuple] = None):
        """MLP, the three causal convs and the norm: the LSTM's input. With
        `conv_tails` (streaming), each conv takes its carried tail in place
        of the zero left pad, and the call returns (input, the new tails)."""
        y = self.mlp(x)
        convs = (self.conv_0, self.conv_1, self.conv_2)
        if conv_tails is None:
            for conv in convs:
                y = conv(y)
            return self.fused_norm(y)
        tails = []
        for conv, tail in zip(convs, conv_tails):
            n = tail.shape[1]     # the new tail: the last k-1 rows seen
            tails.append(y[:, y.shape[1] - n:] if y.shape[1] >= n else
                         torch.cat([tail[:, y.shape[1]:].to(y.dtype), y], 1))
            y = conv(y, tail)
        return self.fused_norm(y), tuple(tails)

    def head(self, x):
        return self.mu_layer(self.pre_output(self.lstm_norm(x)))

    def forward(self, x, recurrence: Callable = wavefront_recurrence):
        """The encoder alone, its LSTM as one wavefront through
        `recurrence`: mu_x (B, S, latent)."""
        ((y, _),) = run_lstm_streams([self.lstm(self.pre_lstm(x))],
                                     recurrence)
        return self.head(y)

    def stream(self, x, state: Dict,
               recurrence: Callable = wavefront_recurrence
               ) -> Tuple[torch.Tensor, Dict]:
        """One chunk x (B, S_chunk, C) of a causal encode, from the state
        the previous chunk left (`source_stream_init_state` for the first):
        (mu_x of the chunk, the new state). Chained chunks give what
        `forward` gives on their concatenation. Eval mode only: BatchNorm
        normalizes with its running statistics."""
        if self.training:
            raise RuntimeError("stream needs eval mode (BatchNorm on running "
                               "statistics): call .eval() first")
        y, tails = self.pre_lstm(x, state["conv_tails"])
        stream = self.lstm(y, (state["h"], state["c"]))
        ((y, (h, c)),) = run_lstm_streams([stream], recurrence)
        return self.head(y), {"conv_tails": tails, "h": h, "c": c}

    def get_sequence_encoding(self, x, timestep: int,
                              recurrence: Callable = wavefront_recurrence):
        """The causal encoding up to `timestep` inclusive, as the reference
        computes it: the full forward, sliced (`stream` costs a chunk, not
        the history). Eval mode only, as `stream`."""
        if self.training:
            raise RuntimeError("get_sequence_encoding needs eval mode: call "
                               ".eval() first")
        timestep = min(timestep, x.shape[1] - 1)
        return self(x, recurrence)[:, :timestep + 1]


class ConditionalEncoder(nn.Module):
    """q(z | x, y): concat(mu_x, c_logvar) -> ResidualMLP trunk -> mu and
    logvar heads. The geometric schedule over 8 hidden layers is split 5
    (trunk) + 3 (each head)."""

    def __init__(self, dtype: Dtype = None, dim_hx: int = LATENT_DIM,
                 dim_hy: int = LATENT_DIM, dim_z: int = LATENT_DIM):
        super().__init__()
        dims = geometric_schedule(dim_hx + dim_hy, dim_z, 8)
        self.mlp = ResidualMLP(dim_hx + dim_hy, dims[0:5],
                               final_activation=True, dtype=dtype)
        self.fc_mu = ResidualMLP(dims[4], dims[5:], final_activation=False,
                                 use_skip_connection=False, dtype=dtype)
        self.fc_logvar = ResidualMLP(dims[4], dims[5:], final_activation=False,
                                     use_skip_connection=False, dtype=dtype)

    def forward(self, h_x, h_y):
        h = self.mlp(torch.cat([h_x, h_y], dim=-1))
        return self.fc_mu(h), self.fc_logvar(h)


# (features, kernel, upsample slot?) of the decoder's reflect-conv ladder
DECODER_CONV_SPEC = ((77, 11, False), (66, 9, True), (55, 7, True),
                     (44, 5, False), (33, 5, True), (22, 3, True),
                     (11, 3, False), (1, 3, False))


def decoder_up_slots(upsample_factor: int) -> Tuple[bool, ...]:
    """Which blocks of DECODER_CONV_SPEC upsample 2x for a decimation
    factor: the first log2(factor) of the four upsample slots, the JAX
    Decoder's rule (factor 16 upsamples at all four, 1 at none)."""
    n_up = upsample_factor.bit_length() - 1
    if upsample_factor < 1 or 2 ** n_up != upsample_factor or n_up > 4:
        raise ValueError(f"upsample_factor must be a power of two <= 16, got "
                         f"{upsample_factor}")
    slots, out = 0, []
    for _, _, is_slot in DECODER_CONV_SPEC:
        out.append(is_slot and slots < n_up)
        slots += is_slot
    return tuple(out)


class Decoder(nn.Module):
    """z (B,S,latent) -> (linear_output (B,S,coeff), raw mu/logvar
    (B, f*S)): MLP trunk, 8 reflect-conv blocks with log2(f) 2x-upsample
    stages (f = upsample_factor), two dense heads of width f*seq_len."""

    def __init__(self, coeff_channels: int = 87, seq_len: int = 300,
                 dtype: Dtype = None, latent_dim: int = LATENT_DIM,
                 upsample_factor: int = UPSAMPLE):
        super().__init__()
        self.raw_len = seq_len * upsample_factor
        self.linear_0 = ResidualMLP(latent_dim,
                                    geometric_schedule(latent_dim, 50, 5),
                                    final_activation=True, dtype=dtype)
        self.linear_1 = ResidualMLP(50, geometric_schedule(50, coeff_channels, 5),
                                    final_activation=True, dtype=dtype)
        in_features = coeff_channels
        for i, ((feat, k, _), up) in enumerate(zip(
                DECODER_CONV_SPEC, decoder_up_slots(upsample_factor))):
            self.add_module(f"conv_{i}", ReflectConvBlock(
                in_features, feat, k, up_sampling=up, dtype=dtype))
            in_features = feat
        self.output_mu = ResidualMLP(self.raw_len, (self.raw_len,) * 2,
                                     final_activation=False,
                                     use_skip_connection=False, dtype=dtype)
        self.output_logvar = ResidualMLP(self.raw_len, (self.raw_len,) * 2,
                                         final_activation=False,
                                         use_skip_connection=False,
                                         dtype=dtype)

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


def sample_z(enc: Dict[str, torch.Tensor], deterministic: bool,
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z from the encodings: the posterior mean when deterministic, else
    mu_post + eps * exp(logvar_post / 2) with standard-normal eps drawn
    from `generator` or the caller's `eps` (see `SeqVaeTeb.forward`).
    Under `parallel.noise_rows` (a data-parallel rank) the draw is the
    global batch's and eps is the caller's global eps; both keep the
    rank's rows."""
    mu, logvar = enc["mu_post"], enc["logvar_post"]
    if deterministic:
        return mu
    if eps is None:
        if generator is None:
            raise ValueError("sampling needs an explicit torch.Generator or "
                             "eps")
        eps = draw(torch.randn, mu.shape, generator=generator,
                   dtype=mu.dtype, device=mu.device)
    else:
        eps = local_rows(eps, mu.shape[0])
    if eps.shape != mu.shape:
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                         f"{tuple(mu.shape)}")
    return mu + eps.to(mu) * torch.exp(0.5 * logvar)


class SeqVaeTeb(nn.Module):
    """Full TEB sequence VAE.

    The attribute `recurrence` is the wavefront recurrence both encoder
    LSTMs run through: `kernels.wavefront_recurrence`, which dispatches by
    device (CUDA kernels, or plain PyTorch on the CPU) and, when a gradient
    is recorded, runs the reverse-wavefront backward. A caller may swap in
    `kernels.wavefront_fwd_plain` (autograd then differentiates the plain
    loop) to compare the two on the card.

    Subclasses that decode z otherwise (the forecast and predict-st
    families, `models.variants`) set `raw_decoder = False`: they carry no
    `Decoder`, as flax never creates the parameters of a submodule it
    does not call. Each family owns its training loss (`loss`), which
    the trainer calls.
    """

    raw_decoder = True

    def __init__(self, input_channels: int = 130, n_scattering: int = 43,
                 n_phase: int = 44, lstm_hidden_dim: int = 64,
                 lstm_num_layers: int = 4, seq_len: int = 300,
                 dtype: Dtype = None, latent_dim_source: int = LATENT_DIM,
                 latent_dim_target: int = LATENT_DIM,
                 latent_dim_z: int = LATENT_DIM,
                 decimation_factor: int = UPSAMPLE):
        super().__init__()
        self.dtype = dtype
        self.latent_dim_z = latent_dim_z
        self.n_scattering, self.n_phase = n_scattering, n_phase
        self.decimation_factor = decimation_factor
        self.recurrence: Callable = wavefront_recurrence
        self.source_encoder = SourceEncoder(input_channels, lstm_hidden_dim,
                                            lstm_num_layers, dtype,
                                            latent_dim_source)
        self.target_encoder = TargetEncoder(lstm_hidden_dim, lstm_num_layers,
                                            n_scattering, n_phase, dtype,
                                            latent_dim_target)
        self.conditional_encoder = ConditionalEncoder(
            dtype, latent_dim_source, latent_dim_target, latent_dim_z)
        if self.raw_decoder:
            self.decoder = Decoder(n_scattering + n_phase, seq_len, dtype,
                                   latent_dim_z, decimation_factor)

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
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """deterministic=True decodes the posterior mean; otherwise
        z = mu_post + eps * exp(logvar_post / 2) with standard-normal eps
        drawn from `generator` (on the inputs' device), or the caller's
        `eps` of mu_post's shape (noise shared between two runs, or with
        the JAX package). One of the two is required. eps is drawn in, or
        cast to, mu_post's dtype (the compute dtype) and z is formed in it,
        as the JAX package draws its noise in the compute dtype.

        Spans `model.encode` (the encoders and z) and `model.decode` (the
        decoder and its raw heads); stage marks `encode`, `decode` and,
        where z has a gradient, `decode_backward` (`utils.profiling`)."""
        with profiling.span("model.encode"):
            enc = self.encode(y_st, y_ph, x_ph)
            z = sample_z(enc, deterministic, generator, eps)
            profiling.mark("encode")
            profiling.mark_on_grad(z, "decode_backward")
        with profiling.span("model.decode"):
            linear_output, mu_pr, logvar_pr = self.decoder(z)
            profiling.mark("decode")
        return {"z": z, "linear_output": linear_output,
                "mu_pr": mu_pr, "logvar_pr": logvar_pr, **enc}

    def loss(self, outputs: Dict, y_st, y_ph, y_raw, beta) -> Dict:
        """The family's training loss on its forward's `outputs`, the one
        signature `train.Trainer` calls for every family: a dict holding
        `total_loss`. SeqVaeTeb's is `compute_loss` (reconstruction +
        beta * KL); `beta` may be a 0-dim device tensor."""
        return compute_loss(outputs, y_st, y_ph, y_raw, beta=beta)

    def decode(self, z):
        """The decoder alone (latent interpolation): z (B, S, latent_dim_z)
        -> (linear_output, raw mu, raw logvar), in the module's mode."""
        return self.decoder(z)

    def encode_source_stream(self, x_chunk, state: Dict
                             ) -> Tuple[torch.Tensor, Dict]:
        """One chunk of the causal source encode (`SourceEncoder.stream`
        through `self.recurrence`): (mu_x chunk, new state); the first
        state is `init_source_stream_state(batch_size)`."""
        return self.source_encoder.stream(x_chunk, state, self.recurrence)

    def init_source_stream_state(self, batch_size: int, device=None) -> Dict:
        """The zero state of `encode_source_stream`, in the compute dtype,
        on `device` (the model's parameters' device when None)."""
        lstm = self.source_encoder.lstm
        if device is None:
            device = lstm.w_hh_0.device
        return source_stream_init_state(batch_size, lstm.num_layers,
                                        lstm.hidden_size, self.dtype, device)

    def get_sequence_encoding(self, x_ph, timestep: int):
        """The causal source encoding up to `timestep` inclusive by a full
        forward, sliced (the reference's API)."""
        return self.source_encoder.get_sequence_encoding(x_ph, timestep,
                                                         self.recurrence)

    get_predictions = staticmethod(stitch_predictions)

    def measure_transfer_entropy(self, y_st, y_ph, x_ph):
        """TE(source -> latent) = KL(q(z|x,y) || p(z|y)) per step and dim."""
        enc = self.encode(y_st, y_ph, x_ph)
        return gaussian_kld(enc["mu_prior"], enc["logvar_prior"],
                            enc["mu_post"], enc["logvar_post"],
                            reduce_mean=False)
