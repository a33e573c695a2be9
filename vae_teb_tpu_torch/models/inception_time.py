"""InceptionTime classifier over VAE latents, and the combined
VAE-classifier.

Port of `vae_teb_tpu.models.inception_time`. Layout is (B, S, C) as in the
JAX package; submodule names follow the flax tree (`convert.py`).

Parity with flax:
  - `SameConv1d` pads as flax's padding="SAME" at stride 1: k-1 in all,
    floor((k-1)/2) on the left, so the k=40 branch pads 19 left and 20
    right (the reference's even-kernel asymmetry, fixed to flax's rule);
  - the max-pool branch pads with -inf (window 3, stride 1);
  - `SelfAttention` is flax's `nn.SelfAttention`: q, k, v projections with
    per-head biases (kernels (C, heads, head_dim), kept in flax's layout),
    q scaled by 1/sqrt(head_dim), softmax over keys, dropout on the
    attention weights with one mask shared by every batch row and head
    (flax's broadcast_dropout), and the out projection (heads, head_dim,
    C);
  - dropout keeps an element with probability 1 - rate and scales it by
    1 / (1 - rate). Its masks come from the `generator` the forward is
    given (the default generator of the device when None); dropout runs
    in training mode only (`self.training`), as flax's
    `deterministic=not train`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import draw
from .blocks import BatchNorm, Conv1d, Dense, Dtype, LayerNorm, gelu
from .vae_teb import LATENT_DIM, SeqVaeTeb
from .vae_teb import compute_loss as vae_compute_loss


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            shape=None) -> torch.Tensor:
    """flax `nn.Dropout`: in training mode with rate > 0, keep each element
    with probability 1 - rate (a mask of `shape`, broadcast against x, x's
    own shape when None) and divide the kept ones by 1 - rate. A mask of
    x's shape has a row per batch row: under `parallel.noise_rows` it is
    drawn for the global batch and the rank keeps its rows; a broadcast
    mask is shared by every row, so every rank draws the same one."""
    if not training or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    if shape is None:
        u = draw(torch.rand, x.shape, generator=generator, device=x.device)
    else:
        u = torch.rand(shape, generator=generator, device=x.device)
    keep = u < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class SameConv1d(Conv1d):
    """flax `nn.Conv(padding="SAME", use_bias=False)` at stride 1 over
    (B, S, C): k - 1 zeros, floor((k-1)/2) of them on the left."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dtype: Dtype = None):
        super().__init__(in_features, features, kernel_size, dtype)
        left = (kernel_size - 1) // 2
        self.pads = (left, kernel_size - 1 - left)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x.transpose(1, 2), self.pads)
                               ).transpose(1, 2)


class InceptionBlock(nn.Module):
    """Bottleneck, parallel convs k = 5 / 15 / 40 and a max-pool branch,
    concatenated to 4 * filters, then BatchNorm, relu and dropout."""

    def __init__(self, in_features: int, filters: int, dropout: float = 0.1,
                 dtype: Dtype = None):
        super().__init__()
        self.rate = dropout
        self.bottleneck1 = SameConv1d(in_features, filters, 1, dtype)
        self.conv_short = SameConv1d(filters, filters, 5, dtype)
        self.conv_medium = SameConv1d(filters, filters, 15, dtype)
        self.conv_long = SameConv1d(filters, filters, 40, dtype)
        self.bottleneck2 = SameConv1d(in_features, filters, 1, dtype)
        self.bn = BatchNorm(4 * filters, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x0 = self.bottleneck1(x)
        pooled = F.max_pool1d(x.transpose(1, 2), 3, stride=1, padding=1
                              ).transpose(1, 2)
        y = torch.cat([self.conv_short(x0), self.conv_medium(x0),
                       self.conv_long(x0), self.bottleneck2(pooled)], dim=-1)
        y = F.relu(self.bn(y))
        return dropout(y, self.rate, self.training, generator)


class ResidualBlock(nn.Module):
    """A 1x1 bottleneck and BatchNorm on the skip, added, relu, dropout."""

    def __init__(self, in_features: int, filters: int, dropout: float = 0.1,
                 dtype: Dtype = None):
        super().__init__()
        self.rate = dropout
        self.bottleneck = SameConv1d(in_features, 4 * filters, 1, dtype)
        self.bn = BatchNorm(4 * filters, dtype)

    def forward(self, x_skip: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.relu(y + self.bn(self.bottleneck(x_skip)))
        return dropout(y, self.rate, self.training, generator)


class _HeadsDense(nn.Module):
    """flax `DenseGeneral(features=(heads, head_dim))` over the last axis:
    weight (C, heads, head_dim), bias (heads, head_dim)."""

    def __init__(self, features: int, heads: int, head_dim: int,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return (torch.einsum("bsc,chd->bshd", x.to(dt), self.weight.to(dt))
                + self.bias.to(dt))


class _OutDense(nn.Module):
    """flax `DenseGeneral(features=C, axis=(-2, -1))`: weight (heads,
    head_dim, C), bias (C,)."""

    def __init__(self, heads: int, head_dim: int, features: int,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(heads, head_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return (torch.einsum("bshd,hdc->bsc", x.to(dt), self.weight.to(dt))
                + self.bias.to(dt))


class SelfAttention(nn.Module):
    """flax `nn.SelfAttention(num_heads, dropout_rate)` over (B, S, C)."""

    def __init__(self, features: int, num_heads: int = 4,
                 dropout: float = 0.0, dtype: Dtype = None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into "
                             f"{num_heads} heads")
        head_dim = features // num_heads
        self.rate = dropout
        self.query = _HeadsDense(features, num_heads, head_dim, dtype)
        self.key = _HeadsDense(features, num_heads, head_dim, dtype)
        self.value = _HeadsDense(features, num_heads, head_dim, dtype)
        self.out = _OutDense(num_heads, head_dim, features, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)   # (B, S, h, d)
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        # one keep mask for every batch row and head
        w = dropout(w, self.rate, self.training, generator,
                    (1, 1) + w.shape[-2:])
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class InceptionTimeClassifier(nn.Module):
    """Input LayerNorm and projection, `depth` inception blocks (a
    residual block after every third), optional 4-head self-attention,
    mean over the sequence, then a 3-layer MLP head to the class logits.
    The input (B, S, input_size) is the VAE's latent."""

    def __init__(self, input_size: int = LATENT_DIM, num_classes: int = 2,
                 filters: int = 32, depth: int = 6, dropout: float = 0.2,
                 use_attention: bool = True, dtype: Dtype = None):
        super().__init__()
        self.rate = dropout
        self.depth = depth
        f4 = 4 * filters
        self.norm = nn.ModuleList([LayerNorm(input_size, dtype),
                                   LayerNorm(2 * filters, dtype),
                                   LayerNorm(filters, dtype)])
        self.dense = nn.ModuleList([Dense(input_size, input_size, dtype=dtype),
                                    Dense(f4, 2 * filters, dtype=dtype),
                                    Dense(2 * filters, filters, dtype=dtype),
                                    Dense(filters, num_classes, dtype=dtype)])
        residual_in = input_size
        for d in range(depth):
            self.add_module(f"inception_{d}", InceptionBlock(
                input_size if d == 0 else f4, filters, dropout, dtype))
            if d % 3 == 2:
                self.add_module(f"residual_{d // 3}", ResidualBlock(
                    residual_in, filters, dropout, dtype))
                residual_in = f4
        self.attention = (SelfAttention(f4, 4, dropout, dtype)
                          if use_attention else None)
        self.attention_norm = LayerNorm(f4, dtype) if use_attention else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t, rate: dropout(t, rate, self.training, generator)
        x = drop(gelu(self.dense[0](self.norm[0](x))), self.rate * 0.5)
        residual_input = y = x
        for d in range(self.depth):
            y = getattr(self, f"inception_{d}")(y, generator)
            if d % 3 == 2:
                y = getattr(self, f"residual_{d // 3}")(residual_input, y,
                                                        generator)
                residual_input = y
        if self.attention is not None:
            y = self.attention_norm(y + self.attention(y, generator))
        y = y.mean(dim=1)   # global average pool over the sequence
        for i in (1, 2):
            y = drop(gelu(self.norm[i](self.dense[i](y))), self.rate)
        return self.dense[3](y)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean cross-entropy of integer labels, the log-softmax in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


class SeqVaeTebClassifier(nn.Module):
    """SeqVaeTeb latents through an InceptionTime head.

    With `freeze_vae` the VAE runs in eval mode (BatchNorm on its running
    statistics) whatever the wrapper's mode, records no autograd graph, and
    z is detached: its parameters get no gradient (the functional analogue
    of the reference's requires_grad_(False)). Loading a pretrained VAE is
    `train.checkpoint.transfer_params`. `vae_kwargs` go to SeqVaeTeb
    (seq_len, LSTM sizes, ...); the JAX wrapper takes its defaults.
    """

    def __init__(self, num_classes: int = 2, classifier_filters: int = 32,
                 classifier_depth: int = 6, classifier_dropout: float = 0.2,
                 use_attention: bool = True, freeze_vae: bool = True,
                 latent_dim_z: int = LATENT_DIM, dtype: Dtype = None,
                 **vae_kwargs):
        super().__init__()
        self.freeze_vae = freeze_vae
        self.vae_model = SeqVaeTeb(latent_dim_z=latent_dim_z, dtype=dtype,
                                   **vae_kwargs)
        self.classifier = InceptionTimeClassifier(
            input_size=latent_dim_z, num_classes=num_classes,
            filters=classifier_filters, depth=classifier_depth,
            dropout=classifier_dropout, use_attention=use_attention,
            dtype=dtype)

    def train(self, mode: bool = True) -> "SeqVaeTebClassifier":
        super().train(mode)
        if self.freeze_vae:
            self.vae_model.eval()
        return self

    def forward(self, y_st, y_ph, x_ph, deterministic_latent: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Dict:
        """{logits, probabilities, predictions, latent_z, vae_outputs}. z is
        sampled (from `generator` or the caller's `eps`) unless
        deterministic_latent; `generator` also draws the head's dropout."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_vae):
            outputs = self.vae_model(y_st, y_ph, x_ph,
                                     deterministic=deterministic_latent,
                                     generator=generator, eps=eps)
        z = outputs["z"].detach() if self.freeze_vae else outputs["z"]
        logits = self.classifier(z, generator)
        return {"logits": logits,
                "probabilities": torch.softmax(logits, dim=-1),
                "predictions": torch.argmax(logits, dim=-1),
                "latent_z": z, "vae_outputs": outputs}

    @staticmethod
    def compute_loss(outputs: Dict, labels, y_st=None, y_ph=None, y_raw=None,
                     compute_vae_loss: bool = False,
                     vae_loss_weight: float = 0.1) -> Dict:
        """CE + vae_loss_weight * the VAE's ELBO (beta 1), the ELBO only
        with compute_vae_loss and y_raw."""
        cls_loss = cross_entropy_loss(outputs["logits"], labels)
        vae_total = torch.zeros((), dtype=torch.float32, device=cls_loss.device)
        if compute_vae_loss and y_raw is not None:
            vae_total = vae_compute_loss(outputs["vae_outputs"], y_st, y_ph,
                                         y_raw, beta=1.0)["total_loss"]
        return {"classification_loss": cls_loss, "vae_loss": vae_total,
                "total_loss": cls_loss + vae_loss_weight * vae_total}
