"""Plain reference of the VAE-TEB direct-window forecaster
(`SeqVaeTebForecast(decoder_type="direct")`): its parameter shapes, its
forward pass, its loss, and its first three training steps, written as
plain PyTorch over a dict of tensors named as the program's
`state_dict()` names them. Float64 by default; every product goes
through a `Precision`, so a control can lower it.

The encoders are SeqVaeTeb's, from `model.Model`. The decoder follows the
published forecaster (Mahdi-Si/VAE-TEB,
model/vae_teb_model_prediction_directly.py, decoder :780-896, loss
:898-934): from z (B, S, latent) three paths run side by side and are
summed,

  linear          a residual MLP, latent -> hidden (4 hidden layers on a
                  geometric schedule, final activation)
  lstm            a 3-layer LSTM of `hidden` units, run here step by step,
                  one layer after another, from a zero state
  convs           six causal convolutions (k = 3, 5, 7, 11, 19, 29, each
                  `hidden` channels) with BatchNorm and relu, one after
                  another

then a residual MLP processor (hidden -> 360) and two residual MLP heads
(360 -> horizon, 5 hidden layers, no final activation, no skip) give each
step's mean and log-variance (clipped to [-8, 8]) of the next `horizon`
raw samples. The loss is the Gaussian NLL of each step t in [warmup, S)
whose window [t dec, t dec + horizon) lies inside the raw signal, the
mean over batch, kept steps and samples, plus beta times the KL of the
posterior from the prior (summed over the latent, averaged over batch
and steps).

Departures from the published source, each also the program's:
  - layout (B, S, C), as `model.Model` has it; the source's convolutions
    run on (B, C, S);
  - LayerNorm eps 1e-6 and BatchNorm with flax's arithmetic (biased batch
    variance, eps 1e-5), as in `model.Model`;
  - the window gather is one index table here, where the source loops
    over the ~240 steps; the same elements and the same mean;
  - weights are the harness's seeded draw (`weights.py`: xavier-uniform,
    LSTM forget-gate bias 1), not the source's orthogonal LSTM kernels;
  - nothing is stitched or sampled after training: the source's
    evaluation helpers are not part of a training step.

The decoder's widths (hidden, horizon, warmup, the 360-wide processor)
are the published ones; `hidden`, `prediction_horizon` and
`warmup_period` come from the configuration's `model`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import weights
from .model import (AdamW, Model, geometric_schedule, is_buffer, mlp_spec,
                    param_shapes as vae_param_shapes)
from .precision import Precision
from .train import normalize

DECODER = "window_decoder"
DIRECT_CONVS = (3, 5, 7, 11, 19, 29)
PROCESSOR = 360          # the processor's width in the published decoder
LSTM_LAYERS = 3


def decoder_architecture(cfg: Mapping) -> Dict[str, Dict]:
    """The direct decoder's residual MLPs by name."""
    L, H, P = cfg["latent_dim"], cfg["hidden"], cfg["prediction_horizon"]
    g = geometric_schedule
    return {
        f"{DECODER}.linear": mlp_spec(L, g(L, H, 4), True),
        f"{DECODER}.final_processor": mlp_spec(H, g(H, PROCESSOR, 4), True),
        f"{DECODER}.output_mu": mlp_spec(PROCESSOR, g(PROCESSOR, P, 5),
                                         False, False),
        f"{DECODER}.output_logvar": mlp_spec(PROCESSOR, g(PROCESSOR, P, 5),
                                             False, False),
    }


def _mlp_shapes(shapes, name, m):
    dims = (m["n_in"],) + m["widths"]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"{name}.dense.{i}.weight"] = (b, a)
        shapes[f"{name}.dense.{i}.bias"] = (b,)
    n_norm = len(m["widths"]) if m["final"] else len(m["widths"]) - 1
    for i, w in enumerate(dims[:n_norm + 1]):
        shapes[f"{name}.norm.{i}.weight"] = (w,)
        shapes[f"{name}.norm.{i}.bias"] = (w,)
    if m["skip"] and m["n_in"] != m["widths"][-1]:
        shapes[f"{name}.skip_proj.weight"] = (m["widths"][-1], m["n_in"])
        shapes[f"{name}.skip_proj.bias"] = (m["widths"][-1],)


def param_shapes(cfg: Mapping) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every parameter's name and shape, and the BatchNorm statistics: the
    encoders' as SeqVaeTeb's (`model.param_shapes` without its raw
    decoder), then the direct decoder's."""
    shapes = OrderedDict((k, v) for k, v in vae_param_shapes(cfg).items()
                         if not k.startswith("decoder."))
    arch = decoder_architecture(cfg)
    L, H = cfg["latent_dim"], cfg["hidden"]
    _mlp_shapes(shapes, f"{DECODER}.linear", arch[f"{DECODER}.linear"])
    for l in range(LSTM_LAYERS):
        shapes[f"{DECODER}.lstm.w_ih_{l}"] = (L if l == 0 else H, 4 * H)
        shapes[f"{DECODER}.lstm.w_hh_{l}"] = (H, 4 * H)
        shapes[f"{DECODER}.lstm.bias_{l}"] = (4 * H,)
    c_in = L
    for i, k in enumerate(DIRECT_CONVS):
        shapes[f"{DECODER}.conv_{i}.conv.conv.weight"] = (H, c_in, k)
        for key in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{DECODER}.conv_{i}.bn.{key}"] = (H,)
        c_in = H
    for name in ("final_processor", "output_mu", "output_logvar"):
        _mlp_shapes(shapes, f"{DECODER}.{name}", arch[f"{DECODER}.{name}"])
    return shapes


class ForecastModel(Model):
    """SeqVaeTeb's encoders (`Model.encode`) and the direct decoder over
    parameters `P` in the precision `pol`; `train` picks batch statistics
    over running ones."""

    def __init__(self, cfg: Mapping, P: Mapping[str, torch.Tensor],
                 pol: Optional[Precision] = None, train: bool = True):
        super().__init__(cfg, P, pol, train)
        self.arch = {**self.arch, **decoder_architecture(cfg)}

    def lstm_layers(self, name, x, H, layers):
        """`layers` LSTM layers of H units over all S steps in turn (gates
        i, f, g, o), each from a zero state."""
        B, S, _ = x.shape
        y = x
        for l in range(layers):
            xp = self.pol.store(self.pol.mm(y, self.P[f"{name}.w_ih_{l}"]) +
                                self.P[f"{name}.bias_{l}"].to(self.pol.real))
            w_hh = self.P[f"{name}.w_hh_{l}"]
            h = c = xp.new_zeros((B, H))
            hs = []
            for t in range(S):
                gates = xp[:, t] + self.pol.mm(h, w_hh)
                i, f, g, o = gates.chunk(4, dim=-1)
                c = self.pol.store(torch.sigmoid(f) * c +
                                   torch.sigmoid(i) * torch.tanh(g))
                h = self.pol.store(torch.sigmoid(o) * torch.tanh(c))
                hs.append(h)
            y = torch.stack(hs, dim=1)
        return y

    def decode(self, z):
        """z (B, S, latent) -> (mu, logvar), each (B, S, horizon)."""
        d = DECODER
        x_linear = self.mlp(f"{d}.linear", z)
        x_lstm = self.lstm_layers(f"{d}.lstm", z, self.cfg["hidden"],
                                  LSTM_LAYERS)
        x_conv = z
        for i, k in enumerate(DIRECT_CONVS):
            x_conv = self.causal_block(f"{d}.conv_{i}", x_conv, k)
        x = self.mlp(f"{d}.final_processor", x_linear + x_lstm + x_conv)
        mu = self.mlp(f"{d}.output_mu", x)
        logvar = torch.clamp(self.mlp(f"{d}.output_logvar", x), -8.0, 8.0)
        return mu, logvar

    def forward(self, y_st, y_ph, x_ph, eps=None):
        """{z, window_mu, window_logvar and the encodings}; z is the
        posterior mean when `eps` is None, else mu_post + eps *
        exp(logvar_post / 2)."""
        r = self.pol.real
        enc = self.encode(y_st.to(r), y_ph.to(r), x_ph.to(r))
        z = enc["mu_post"]
        if eps is not None:
            z = z + eps.to(r) * torch.exp(0.5 * enc["logvar_post"])
        mu, logvar = self.decode(z)
        return {"z": z, "window_mu": mu, "window_logvar": logvar, **enc}


def forecast_loss(out: Mapping, y_raw, beta: float, warmup: int,
                  decimation: int) -> Dict[str, torch.Tensor]:
    """{nll_loss, kld_loss, total_loss}: the sliding-window Gaussian NLL
    over the kept steps (0 where none is kept) plus beta times the KL."""
    mu, logvar = out["window_mu"], out["window_logvar"]
    S, H = mu.shape[1], mu.shape[2]
    kept = [t for t in range(max(warmup, 0), S)
            if t * decimation + H <= y_raw.shape[1]]
    r = mu.dtype
    if kept:
        index = torch.as_tensor(np.asarray(kept)[:, None] * decimation
                                + np.arange(H)[None, :], device=mu.device)
        target = y_raw.to(r)[:, index]                     # (B, T, H)
        steps = torch.as_tensor(kept, device=mu.device)
        m, lv = mu[:, steps], logvar[:, steps]
        nll = torch.mean(0.5 * (lv + (target - m) ** 2 / torch.exp(lv)))
    else:
        nll = torch.zeros((), dtype=r, device=mu.device)
    lp, lq = out["logvar_prior"], out["logvar_post"]
    kld = (0.5 * (lp - lq - 1.0 + (torch.exp(lq) + (out["mu_post"]
                                                    - out["mu_prior"]) ** 2)
                  / torch.exp(lp))).sum(-1).mean()
    return {"nll_loss": nll, "kld_loss": kld, "total_loss": nll + beta * kld}


def _step_with_gradients(opt: AdamW) -> Dict[str, torch.Tensor]:
    """`opt.step()` over the parameters that have a gradient: a parameter
    the loss does not reach (the decoder where no window is kept) is left
    as it is, as the program's optimizer leaves it."""
    every = opt.params
    opt.params = {k: p for k, p in every.items() if p.grad is not None}
    try:
        clipped = opt.step()
    finally:
        opt.params = every
    return {k: clipped.get(k, torch.zeros_like(p)) for k, p in every.items()}


def reference_steps(cfg: Mapping, shapes: Mapping,
                    pool: Mapping[str, np.ndarray], stats: Mapping,
                    rows: Sequence[np.ndarray], seed: int, batch: int, device,
                    precision: Optional[str] = None,
                    fault: Optional[str] = None) -> Dict:
    """The forecaster's first three training steps from the seed's
    weights, the rows the program stepped on and the noise it was handed:
    {"losses": [3], "grad": {leaf: norm of step 1's clipped gradient},
    "change": {leaf: norm of the parameters' change over three steps}}.
    Fields normalized as `train.normalize` does; the forward in training
    mode, the loss differentiated by autograd, then `AdamW`, all in the
    precision given (float64 unless a control lowers it).

    `fault="half_batch"` plants a fault for calibration: each step's loss
    is the mean over the first half of the rows only. TF32 is switched off
    for matrix products and convolutions, so that a float32 control rounds
    only where its `Precision` rounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, tc = cfg["model"], cfg["trainer"]
    pol = Precision(precision)
    made = weights.make(shapes, seed, device)
    params = {n: v.to(pol.real).requires_grad_(True) for n, v in made.items()
              if not is_buffer(n)}
    bufs = {n: v.to(pol.real) for n, v in made.items() if is_buffer(n)}
    start = {n: p.detach().clone() for n, p in params.items()}
    del made
    opt = AdamW(params, tc["lr"], tc["grad_clip_norm"], tc["weight_decay"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    eps_shape = (batch, m["seq_len"], m["latent_dim"])
    eps = [torch.randn((1,) + eps_shape, generator=gen, device=device)[0]]
    eps += list(torch.randn((2,) + eps_shape, generator=gen, device=device))
    model = ForecastModel(m, {**params, **bufs}, pol, train=True)
    losses, grad = [], {}
    for step in range(3):
        keep = slice(None) if fault != "half_batch" else slice(0, batch // 2)
        fields = normalize({f: v[rows[step]][keep] for f, v in pool.items()},
                           stats, pol.real, device)
        out = model.forward(*fields[:3], eps=eps[step][keep])
        loss = forecast_loss(out, fields[3], tc["kld_beta"],
                             m["warmup_period"], m["decimation_factor"]
                             )["total_loss"]
        for p in params.values():
            p.grad = None
        loss.backward()
        clipped = _step_with_gradients(opt)
        losses.append(float(loss.detach()))
        if step == 0:
            grad = {n: float(g.norm()) for n, g in clipped.items()}
        del out, loss, clipped
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in params.items()}
    return {"losses": losses, "grad": grad, "change": change}
