"""Model blocks: residual MLPs, causal and reflect conv blocks, the LSTM.

Port of `vae_teb_tpu.models.blocks` (eval mode). Layout is (B, S, C)
throughout, as in the JAX package; convolutions transpose to PyTorch's
(B, C, S) around `F.conv1d` only. Submodule names follow the flax
parameter tree so `convert.py` can map a flax checkpoint mechanically.

Parity with flax: LayerNorm eps is 1e-6 (PyTorch's default is 1e-5); flax's
`nn.gelu` is the tanh approximation; BatchNorm normalizes with its running
statistics (eps 1e-5).

The LSTMs run in the wavefront schedule only: all layers of all fused
streams advance as one staircase recurrence whose step is one product with
a packed block-bidiagonal weight (see `run_lstm_streams`). The recurrence
is `kernels.wavefront_fwd`, a CUDA kernel on the card and plain PyTorch on
the CPU.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import wavefront_fwd

LAYER_NORM_EPS = 1e-6   # flax nn.LayerNorm default
BATCH_NORM_EPS = 1e-5   # flax nn.BatchNorm default


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def geometric_schedule(input_size: int, output_size: int, n_hidden: int
                       ) -> Tuple[int, ...]:
    """Geometric interpolation of layer widths from input to output size;
    returns n_hidden+1 sizes ending exactly at output_size."""
    steps = n_hidden + 1
    r = (output_size / input_size) ** (1.0 / steps)
    sizes = []
    cur = r
    for _ in range(n_hidden):
        sizes.append(int(round(input_size * cur)))
        cur *= r
    sizes.append(output_size)
    return tuple(sizes)


def linear_upsample(x: torch.Tensor) -> torch.Tensor:
    """Linear 2x upsampling of (B, S, C) along S with half-pixel centres
    (the JAX package's `jax.image.resize(method="linear")`)."""
    y = F.interpolate(x.transpose(1, 2), size=x.shape[1] * 2,
                      mode="linear", align_corners=False)
    return y.transpose(1, 2)


def _layer_norm(features: int) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=LAYER_NORM_EPS)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the last axis: flax
    `nn.BatchNorm(use_running_average=True)` arithmetic."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BATCH_NORM_EPS) * self.weight
        return (x - self.running_mean) * mul + self.bias


def _conv_bsc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to (B, S, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ResidualMLP(nn.Module):
    """LayerNorm(input) -> [Linear -> LN -> act]* -> optional skip.

    The final layer drops act and LN when final_activation=False; the skip
    reads the normalized input and projects it when the widths differ.
    `norm[0]` is the input norm and `norm[i + 1]` follows `dense[i]`.
    """

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 final_activation: bool = True,
                 activation: Callable = F.relu,
                 use_skip_connection: bool = True):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        self.final_activation = final_activation
        self.activation = activation
        self.use_skip_connection = use_skip_connection
        dims = (in_features,) + hidden_dims
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        n_norm = len(hidden_dims) if final_activation else len(hidden_dims) - 1
        self.norm = nn.ModuleList(_layer_norm(w) for w in
                                  (in_features,) + hidden_dims[:n_norm])
        self.skip_proj = (nn.Linear(in_features, hidden_dims[-1])
                          if use_skip_connection
                          and in_features != hidden_dims[-1] else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.norm[0](x)
        y = x0
        last = len(self.dense) - 1
        for i, dense in enumerate(self.dense):
            y = dense(y)
            if i < last or self.final_activation:
                y = self.norm[i + 1](y)
            if i < last:
                y = self.activation(y)
        if self.final_activation:
            y = self.activation(y)
        if self.use_skip_connection:
            y = y + (self.skip_proj(x0) if self.skip_proj is not None else x0)
        return y


class CausalConv1d(nn.Module):
    """Left-padded 1-D convolution over (B, S, C), no bias: no future
    leakage."""

    def __init__(self, in_features: int, features: int, kernel_size: int):
        super().__init__()
        self.pad = kernel_size - 1
        self.conv = nn.Conv1d(in_features, features, kernel_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_bsc(self.conv, F.pad(x, (0, 0, self.pad, 0)))


class CausalConvBlock(nn.Module):
    """Causal conv -> BatchNorm -> relu."""

    def __init__(self, in_features: int, features: int, kernel_size: int):
        super().__init__()
        self.conv = CausalConv1d(in_features, features, kernel_size)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ReflectConvBlock(nn.Module):
    """Optional 2x upsample -> reflect-padded 'same' conv -> BatchNorm ->
    relu. A sequence too short to reflect (S <= p) is edge-padded."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 up_sampling: bool = False):
        super().__init__()
        self.up_sampling = up_sampling
        self.pad = (kernel_size - 1) // 2
        self.conv = nn.Conv1d(in_features, features, kernel_size, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_sampling:
            x = linear_upsample(x)
        x = x.transpose(1, 2)
        p = self.pad
        if p > 0:
            mode = "replicate" if x.shape[-1] <= p else "reflect"
            x = F.pad(x, (p, p), mode=mode)
        return F.relu(self.bn(self.conv(x).transpose(1, 2)))


# ---------------------------------------------------------------------------
# LSTM in the wavefront schedule
# ---------------------------------------------------------------------------

class LSTMStream:
    """A prepared multi-layer LSTM invocation: the hoisted layer-0 input
    projection, the per-layer weights and the initial (h, c) tuples.
    Produced by `LSTM.forward`; `run_lstm_streams` runs several independent
    streams as one recurrence."""

    def __init__(self, x_proj, w_ih, w_hh, biases, init):
        self.x_proj = x_proj          # (B, S, 4H)
        self.w_ih = w_ih              # per-layer input kernels (in, 4H)
        self.w_hh = w_hh              # per-layer recurrent kernels (H, 4H)
        self.biases = biases          # per-layer biases (4H,)
        self.init = init              # (hs tuple, cs tuple)


def _wavefront_meta(operands):
    """Packing geometry: units ordered stream-major, layer-minor."""
    H = operands[0]["w_hh"][0].shape[0]
    depths = [len(op["w_hh"]) for op in operands]
    offsets = [int(o) for o in np.cumsum([0] + depths[:-1])]
    U = sum(depths)
    D = max(depths)
    lvec = np.concatenate([np.arange(d) for d in depths]).astype(np.int32)
    return H, depths, offsets, U, D, lvec


def _wavefront_pack(operands, H, depths, offsets, U):
    """Pack per-unit weights into the block-bidiagonal wavefront matrix.

    W_eff is (U*H, 4*U*H): row block v (unit v's h columns in the packed
    state) holds W_hh[v] at unit v's gate columns and, when unit v+1 is a
    deeper layer of the same stream, W_ih[v+1] at unit v+1's gate columns,
    so h_cat @ W_eff gives every unit's recurrent and inter-layer input in
    one product. Columns are gate-major: gate q of unit u lives at
    [q*U*H + u*H, q*U*H + (u+1)*H). Also returns the gate-major biases of
    the layers >= 1 (layer 0's bias rides in xs).
    """
    ref = operands[0]["xs"]
    UH = U * H
    W_eff = torch.zeros((UH, 4 * UH), dtype=ref.dtype, device=ref.device)
    blocks = W_eff.view(U, H, 4, U, H)
    b4 = torch.zeros((4, U, H), dtype=ref.dtype, device=ref.device)
    for s, op in enumerate(operands):
        for l in range(depths[s]):
            u = offsets[s] + l
            blocks[u, :, :, u, :] = op["w_hh"][l].reshape(H, 4, H)
            if l:
                blocks[u - 1, :, :, u, :] = op["w_ih_rest"][l - 1].reshape(H, 4, H)
                b4[:, u, :] = op["b_rest"][l - 1].reshape(4, H)
    return W_eff, b4.reshape(4 * UH)


def _wavefront_xs(operands, H, depths, offsets, U, K, S):
    """(K, B, 4*U*H) additive gate input: each stream's pre-projected xs at
    its layer-0 unit's gate-major columns for k < S, zeros elsewhere."""
    ref = operands[0]["xs"]
    B = ref.shape[1]
    xs = torch.zeros((K, B, 4, U, H), dtype=ref.dtype, device=ref.device)
    for s, op in enumerate(operands):
        xs[:S, :, :, offsets[s], :] = op["xs"].reshape(S, B, 4, H)
    return xs.reshape(K, B, 4 * U * H)


def _wavefront_unpack(h_fin, c_fin, h_seq, operands):
    """Slice the packed outputs back to per stream (ys (S, B, H), h_f
    tuple, c_f tuple): a stream's top layer finishes step t at step
    t + depth - 1."""
    H, depths, offsets, U, D, _ = _wavefront_meta(operands)
    S = operands[0]["xs"].shape[0]
    outs = []
    for s in range(len(operands)):
        d, off = depths[s], offsets[s]
        top = off + d - 1
        ys = h_seq[d - 1:d - 1 + S, :, top * H:(top + 1) * H]
        h_f = tuple(h_fin[:, (off + l) * H:(off + l + 1) * H] for l in range(d))
        c_f = tuple(c_fin[:, (off + l) * H:(off + l + 1) * H] for l in range(d))
        outs.append((ys, h_f, c_f))
    return outs


def run_lstm_streams(streams: Sequence[LSTMStream],
                     recurrence: Callable = wavefront_fwd
                     ) -> List[Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Run independent prepared LSTM streams as ONE wavefront recurrence.

    Unit (stream, layer l) at step k computes time t = k - l from its own
    h and from layer l-1's h of step k-1, so every unit of every stream
    advances in the same step: K = S + D - 1 steps in all (D the deepest
    stream), each one product with the packed W_eff.

    `recurrence` is the forward recurrence; the default dispatches by
    device to the CUDA kernel or its plain version. Returns, per stream,
    (ys (B, S, H), (h_stack, c_stack)) with the final states stacked
    (num_layers, B, H).
    """
    hs = {st.w_hh[0].shape[0] for st in streams}
    if len(hs) != 1:
        raise ValueError(f"the wavefront needs one shared hidden size, got {hs}")
    operands = [{"xs": st.x_proj.transpose(0, 1),
                 "w_ih_rest": st.w_ih[1:],
                 "w_hh": st.w_hh,
                 "b_rest": st.biases[1:],
                 "init_h": st.init[0],
                 "init_c": st.init[1]} for st in streams]
    H, depths, offsets, U, D, lvec = _wavefront_meta(operands)
    S = operands[0]["xs"].shape[0]
    K = S + D - 1
    W_eff, b_packed = _wavefront_pack(operands, H, depths, offsets, U)
    xs_wave = _wavefront_xs(operands, H, depths, offsets, U, K, S)
    h0 = torch.cat([h for op in operands for h in op["init_h"]], dim=-1)
    c0 = torch.cat([c for op in operands for c in op["init_c"]], dim=-1)
    h_seq, h_fin, c_fin = recurrence(
        W_eff, b_packed, xs_wave, h0.contiguous(), c0.contiguous(),
        torch.as_tensor(lvec, device=xs_wave.device), S)
    return [(ys.transpose(0, 1), (torch.stack(h_f), torch.stack(c_f)))
            for ys, h_f, c_f in _wavefront_unpack(h_fin, c_fin, h_seq, operands)]


class LSTM(nn.Module):
    """Multi-layer unidirectional LSTM over (B, S, C), gate order [i, f, g, o],
    zero initial state. Calling it prepares an LSTMStream (the JAX package's
    `prepare=True`); `run_lstm_streams` runs the recurrence.

    Kernels keep the flax layout: w_ih_l (in, 4H), w_hh_l (H, 4H), bias_l
    (4H,), so a flax checkpoint maps over unchanged and the wavefront packs
    exactly as the JAX package does.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        in_dim = input_size
        for l in range(num_layers):
            self.register_parameter(
                f"w_ih_{l}", nn.Parameter(torch.empty(in_dim, 4 * hidden_size)))
            self.register_parameter(
                f"w_hh_{l}", nn.Parameter(torch.empty(hidden_size, 4 * hidden_size)))
            self.register_parameter(
                f"bias_{l}", nn.Parameter(torch.zeros(4 * hidden_size)))
            in_dim = hidden_size

    def _params(self, name: str) -> List[torch.Tensor]:
        return [getattr(self, f"{name}_{l}") for l in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> LSTMStream:
        w_ih, w_hh, biases = (self._params("w_ih"), self._params("w_hh"),
                              self._params("bias"))
        # hoist layer 0's input projection out of the recurrence
        x_proj = x @ w_ih[0] + biases[0]
        zeros = (x.new_zeros((x.shape[0], self.hidden_size)),) * self.num_layers
        return LSTMStream(x_proj, w_ih, w_hh, biases, (zeros, zeros))
