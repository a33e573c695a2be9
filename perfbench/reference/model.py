"""Plain reference of SeqVaeTeb: its parameter shapes, its forward pass, its
ELBO, and the clipped AdamW step, written as plain PyTorch over a dict of
tensors named as the model's `state_dict()` names them.

It follows the published architecture (the sequence VAE with a target
encoder bank): per-modality residual MLPs (LayerNorm eps 1e-6, tanh gelu
on the scattering branch, relu elsewhere), causal convolutions with
BatchNorm (flax arithmetic: biased batch variance, eps 1e-5), stacked
LSTMs (gates i, f, g, o) run step by step, one layer after another, the
conditional encoder, and the decoder's reflect-padded conv ladder with
linear 2x upsampling and its two dense heads over the raw signal. Layout
is (B, S, C). Nothing here is taken from the measured program; every
product goes through a `Precision`, float64 by default.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

LN_EPS = 1e-6
BN_EPS = 1e-5
SOURCE_CONVS = (3, 5, 7)
TARGET_CONVS = (3, 5, 7)
# (features, kernel, upsample slot) of the decoder's conv ladder
DECODER_CONVS = ((77, 11, False), (66, 9, True), (55, 7, True), (44, 5, False),
                 (33, 5, True), (22, 3, True), (11, 3, False), (1, 3, False))


def geometric_schedule(n_in: int, n_out: int, n_hidden: int) -> Tuple[int, ...]:
    """n_hidden + 1 widths from n_in towards n_out in equal ratios."""
    r = (n_out / n_in) ** (1.0 / (n_hidden + 1))
    sizes, cur = [], r
    for _ in range(n_hidden):
        sizes.append(int(round(n_in * cur)))
        cur *= r
    return tuple(sizes) + (n_out,)


def mlp_spec(n_in: int, widths: Sequence[int], final_activation: bool,
             skip: bool = True) -> Dict:
    return dict(n_in=n_in, widths=tuple(widths), final=final_activation,
                skip=skip)


def architecture(cfg: Mapping) -> Dict[str, Dict]:
    """Every residual MLP of the model by name, from the configuration."""
    H, L = cfg["lstm_hidden_dim"], cfg["latent_dim"]
    ns, nph, C = cfg["n_scattering"], cfg["n_phase"], cfg["input_channels"]
    g = geometric_schedule
    dims = g(2 * L, L, 8)
    raw = cfg["seq_len"] * cfg["decimation_factor"]
    coeff = ns + nph
    return {
        "source_encoder.mlp": mlp_spec(C, g(C, 32, 5), False),
        "source_encoder.pre_output": mlp_spec(H, g(H, 32, 4), True),
        "source_encoder.mu_layer": mlp_spec(32, g(32, L, 4), False),
        "target_encoder.mlp_scattering": mlp_spec(ns, g(ns, 16, 4), False),
        "target_encoder.mlp_phase": mlp_spec(nph, g(nph, 16, 4), False),
        "target_encoder.cross_modal_fusion": mlp_spec(32, g(32, 20, 5), False),
        "target_encoder.pre_output": mlp_spec(H, g(H, 32, 5), True),
        "target_encoder.mu_layer": mlp_spec(32, g(32, L, 32), False),
        "target_encoder.logvar_layer": mlp_spec(32, g(32, 2 * L, 4), False),
        "conditional_encoder.mlp": mlp_spec(2 * L, dims[0:5], True),
        "conditional_encoder.fc_mu": mlp_spec(dims[4], dims[5:], False, False),
        "conditional_encoder.fc_logvar": mlp_spec(dims[4], dims[5:], False,
                                                  False),
        "decoder.linear_0": mlp_spec(L, g(L, 50, 5), True),
        "decoder.linear_1": mlp_spec(50, g(50, coeff, 5), True),
        "decoder.output_mu": mlp_spec(raw, (raw, raw), False, False),
        "decoder.output_logvar": mlp_spec(raw, (raw, raw), False, False),
    }


def decoder_up_slots(factor: int) -> Tuple[bool, ...]:
    n_up = int(math.log2(factor))
    slots, out = 0, []
    for _, _, is_slot in DECODER_CONVS:
        out.append(is_slot and slots < n_up)
        slots += is_slot
    return tuple(out)


def param_shapes(cfg: Mapping) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every parameter's name and shape, and the BatchNorm statistics
    (`*.running_mean`, `*.running_var`)."""
    shapes: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    for name, m in architecture(cfg).items():
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

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.bn.{k}"] = (c,)

    def ln(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    def lstm(name, n_in, H, L):
        for l in range(L):
            shapes[f"{name}.w_ih_{l}"] = (n_in if l == 0 else H, 4 * H)
            shapes[f"{name}.w_hh_{l}"] = (H, 4 * H)
            shapes[f"{name}.bias_{l}"] = (4 * H,)

    H, L = cfg["lstm_hidden_dim"], cfg["lstm_num_layers"]
    for i, k in enumerate(SOURCE_CONVS):
        shapes[f"source_encoder.conv_{i}.conv.conv.weight"] = (32, 32, k)
        bn(f"source_encoder.conv_{i}", 32)
    ln("source_encoder.fused_norm", 32)
    lstm("source_encoder.lstm", 32, H, L)
    ln("source_encoder.lstm_norm", H)
    for branch in ("scattering", "phase"):
        for i, k in enumerate(TARGET_CONVS):
            shapes[f"target_encoder.conv_{branch}_{i}.conv.conv.weight"] = (
                16, 16, k)
            bn(f"target_encoder.conv_{branch}_{i}", 16)
    ln("target_encoder.scatter_fused_norm", 16)
    ln("target_encoder.phase_fused_norm", 16)
    lstm("target_encoder.lstm", 20, H, L)
    ln("target_encoder.lstm_norm", H)
    c_in = cfg["n_scattering"] + cfg["n_phase"]
    for i, (feat, k, _) in enumerate(DECODER_CONVS):
        shapes[f"decoder.conv_{i}.conv.weight"] = (feat, c_in, k)
        bn(f"decoder.conv_{i}", feat)
        c_in = feat
    return shapes


def is_buffer(name: str) -> bool:
    return name.endswith(".running_mean") or name.endswith(".running_var")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Model:
    """The forward pass over parameters `P` (name -> tensor) in the
    precision `pol`; `train` picks batch statistics over running ones."""

    def __init__(self, cfg: Mapping, P: Mapping[str, torch.Tensor],
                 pol: Optional[Precision] = None, train: bool = True):
        self.cfg, self.P, self.train = cfg, P, train
        self.pol = pol or Precision()
        self.arch = architecture(cfg)
        self.batch_stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def dense(self, name, x):
        return self.pol.store(self.pol.mm(x, self.P[name + ".weight"].t()) +
                              self.P[name + ".bias"].to(self.pol.real))

    def norm(self, name, x):
        return self.pol.store(F.layer_norm(
            x, (x.shape[-1],), self.P[name + ".weight"].to(x),
            self.P[name + ".bias"].to(x), LN_EPS))

    def act(self, f, x):
        return self.pol.store(f(x))

    def mlp(self, name, x, act=F.relu):
        m = self.arch[name]
        n = len(m["widths"])
        x0 = self.norm(f"{name}.norm.0", x)
        y = x0
        for i in range(n):
            y = self.dense(f"{name}.dense.{i}", y)
            if i < n - 1 or m["final"]:
                y = self.norm(f"{name}.norm.{i + 1}", y)
            if i < n - 1:
                y = self.act(act, y)
        if m["final"]:
            y = self.act(act, y)
        if m["skip"]:
            y = y + (self.dense(f"{name}.skip_proj", x0)
                     if m["n_in"] != m["widths"][-1] else x0)
        return y

    def batch_norm(self, name, x):
        if self.train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            self.batch_stats[name] = (mean.detach(), var.detach())
        else:
            mean = self.P[name + ".running_mean"].to(x)
            var = self.P[name + ".running_var"].to(x)
        return self.pol.store((x - mean) * torch.rsqrt(var + BN_EPS) *
                              self.P[name + ".weight"].to(x) +
                              self.P[name + ".bias"].to(x))

    def conv(self, name, x, pad):
        """(B, S, C) -> (B, S', F) through conv weight `name` (F, C, k) after
        `pad(x)` on the (B, C, S) layout."""
        y = self.pol.conv1d(pad(x.transpose(1, 2)), self.P[name])
        return self.pol.store(y.transpose(1, 2))

    def causal_block(self, name, x, k):
        y = self.conv(f"{name}.conv.conv.weight", x,
                      lambda t: F.pad(t, (k - 1, 0)))
        return self.act(F.relu, self.batch_norm(f"{name}.bn", y))

    def reflect_block(self, name, x, k, up):
        if up:
            x = self.pol.store(F.interpolate(
                x.transpose(1, 2), size=2 * x.shape[1], mode="linear",
                align_corners=False).transpose(1, 2))
        p = (k - 1) // 2
        mode = "replicate" if x.shape[1] <= p else "reflect"
        y = self.conv(f"{name}.conv.weight", x,
                      lambda t: F.pad(t, (p, p), mode=mode) if p else t)
        return self.act(F.relu, self.batch_norm(f"{name}.bn", y))

    def lstm(self, name, x):
        """Each layer over all S steps in turn; zero initial state."""
        B, S, _ = x.shape
        H = self.cfg["lstm_hidden_dim"]
        y = x
        for l in range(self.cfg["lstm_num_layers"]):
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

    # -- the model ------------------------------------------------------------

    def encode(self, y_st, y_ph, x_ph):
        x = self.mlp("source_encoder.mlp", x_ph)
        for i, k in enumerate(SOURCE_CONVS):
            x = self.causal_block(f"source_encoder.conv_{i}", x, k)
        x = self.lstm("source_encoder.lstm",
                      self.norm("source_encoder.fused_norm", x))
        x = self.norm("source_encoder.lstm_norm", x)
        mu_x = self.mlp("source_encoder.mu_layer",
                        self.mlp("source_encoder.pre_output", x))

        te = "target_encoder"
        sc = self.mlp(f"{te}.mlp_scattering", y_st,
                      act=lambda t: F.gelu(t, approximate="tanh"))
        ph = self.mlp(f"{te}.mlp_phase", y_ph)
        for i, k in enumerate(TARGET_CONVS):
            sc = self.causal_block(f"{te}.conv_scattering_{i}", sc, k)
        for i, k in enumerate(TARGET_CONVS):
            ph = self.causal_block(f"{te}.conv_phase_{i}", ph, k)
        y = self.mlp(f"{te}.cross_modal_fusion",
                     torch.cat([self.norm(f"{te}.scatter_fused_norm", sc),
                                self.norm(f"{te}.phase_fused_norm", ph)], -1))
        y = self.mlp(f"{te}.pre_output",
                     self.norm(f"{te}.lstm_norm", self.lstm(f"{te}.lstm", y)))
        mu_y = self.mlp(f"{te}.mu_layer", y)
        logvar_full = torch.clamp(self.mlp(f"{te}.logvar_layer", y), -10.0, 10.0)
        logvar_prior, c_logvar = logvar_full.chunk(2, dim=-1)

        ce = "conditional_encoder"
        h = self.mlp(f"{ce}.mlp", torch.cat([mu_x, c_logvar], -1))
        mu_post = self.mlp(f"{ce}.fc_mu", h) + mu_y
        logvar_post = self.mlp(f"{ce}.fc_logvar", h)
        return {"mu_x": mu_x, "mu_prior": mu_y, "logvar_prior": logvar_prior,
                "mu_post": mu_post, "logvar_post": logvar_post}

    def decode(self, z):
        lin = self.mlp("decoder.linear_1", self.mlp("decoder.linear_0", z))
        x = lin
        ups = decoder_up_slots(self.cfg["decimation_factor"])
        for i, ((_, k, _), up) in enumerate(zip(DECODER_CONVS, ups)):
            x = self.reflect_block(f"decoder.conv_{i}", x, k, up)
        x = x.reshape(x.shape[0], -1)
        return lin, self.mlp("decoder.output_mu", x), \
            self.mlp("decoder.output_logvar", x)

    def forward(self, y_st, y_ph, x_ph, eps=None):
        """All outputs; z is the posterior mean when `eps` is None, else
        mu_post + eps * exp(logvar_post / 2)."""
        r = self.pol.real
        enc = self.encode(y_st.to(r), y_ph.to(r), x_ph.to(r))
        z = enc["mu_post"]
        if eps is not None:
            z = z + eps.to(r) * torch.exp(0.5 * enc["logvar_post"])
        lin, mu, logvar = self.decode(z)
        return {"z": z, "linear_output": lin, "mu_pr": mu, "logvar_pr": logvar,
                **enc}


def calibrated(cfg: Mapping, P: Mapping[str, torch.Tensor], coeffs
               ) -> Dict[str, torch.Tensor]:
    """P with BatchNorm's running statistics moved once towards the batch
    statistics of a training-mode forward on `coeffs` (y_st, y_ph, x_ph):
    running = 0.1 running + 0.9 batch, flax's momentum."""
    model = Model(cfg, P, train=True)
    with torch.no_grad():
        model.forward(*coeffs)
    out = dict(P)
    for name, (mean, var) in model.batch_stats.items():
        for key, batch in ((".running_mean", mean), (".running_var", var)):
            out[name + key] = 0.1 * P[name + key] + 0.9 * batch.to(P[name + key])
    return out


def elbo(out: Mapping, y_st, y_ph, y_raw, beta: float) -> Dict[str, torch.Tensor]:
    """MSE of the coefficient reconstruction, Gaussian NLL of the raw
    signal, beta times KL(posterior || prior) summed over the latent and
    averaged over batch and time."""
    r = out["z"].dtype
    target = torch.cat([y_st.to(r), y_ph.to(r)], dim=-1)
    mse = torch.mean((out["linear_output"] - target) ** 2)
    d = y_raw.to(r) - out["mu_pr"]
    nll = torch.mean(0.5 * (out["logvar_pr"] + d * d / torch.exp(out["logvar_pr"])))
    lp, lq = out["logvar_prior"], out["logvar_post"]
    kld = (0.5 * (lp - lq - 1.0 + (torch.exp(lq) + (out["mu_post"]
                                                    - out["mu_prior"]) ** 2)
                  / torch.exp(lp))).sum(-1).mean()
    return {"mse_loss": mse, "nll_loss": nll, "kld_loss": kld,
            "total_loss": mse + nll + beta * kld}


class AdamW:
    """Global-norm clip (g * max / norm above max, untouched below), Adam
    (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), decoupled weight decay,
    then p -= lr * update, in the parameters' precision."""

    def __init__(self, params: Mapping[str, torch.Tensor], lr: float,
                 clip: float, weight_decay: float):
        self.params = params
        self.lr, self.clip, self.wd = lr, clip, weight_decay
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Update in place; returns each leaf's clipped gradient."""
        grads = {k: p.grad for k, p in self.params.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        self.count += 1
        bc1, bc2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.mu[k].mul_(0.9).add_(0.1 * g)
            self.nu[k].mul_(0.999).add_(0.001 * g * g)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8)
            p.add_(-self.lr * (upd + self.wd * p))
        return clipped
