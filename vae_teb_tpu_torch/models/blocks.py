"""Model blocks: residual MLPs, causal and reflect conv blocks, the LSTM.

Port of `vae_teb_tpu.models.blocks`. Layout is (B, S, C)
throughout, as in the JAX package; convolutions transpose to PyTorch's
(B, C, S) around `F.conv1d` only. Submodule names follow the flax
parameter tree so `convert.py` can map a flax checkpoint mechanically.

Parity with flax: LayerNorm eps is 1e-6 (PyTorch's default is 1e-5); flax's
`nn.gelu` is the tanh approximation; BatchNorm follows flax's arithmetic
and momentum convention (see `BatchNorm`).

Compute dtype: every layer takes flax's `dtype` (None or torch.bfloat16),
the JAX package's precision policy. Parameters stay float32; a layer casts
them to `dtype` inside `forward`, so their gradients come back float32
through the cast. `Dense` and `Conv1d` cast the input, kernel and bias to
`dtype` and multiply in it; `LayerNorm` and `BatchNorm` reduce in float32
(flax's `force_float32_reductions`), normalize in float32 and emit
`dtype`; the LSTM casts its input, weights, biases and initial state, so
the wavefront runs on `dtype` storage. `torch.autocast` is not this
policy: it keeps LayerNorm outputs float32 and chooses its own op list.
`dtype=None` is the float32 path, unchanged.

The LSTMs run in the wavefront schedule only: all layers of all fused
streams advance as one staircase recurrence whose step is one product with
a packed block-bidiagonal weight (see `run_lstm_streams`). The recurrence
is `kernels.wavefront_recurrence`: CUDA kernels on the card (forward, and
the reverse wavefront for gradients) and plain PyTorch on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import wavefront_recurrence
from ..parallel.collectives import all_reduce_sum, copy_to_group, gather_columns

LAYER_NORM_EPS = 1e-6   # flax nn.LayerNorm default
BATCH_NORM_EPS = 1e-5   # flax nn.BatchNorm default
# flax's momentum is the fraction of the running average KEPT:
# running = 0.1 * running + 0.9 * batch (the JAX package's BN_MOMENTUM)
BN_MOMENTUM = 0.1


# gelu's two constants rounded to each dtype below float32, as Python floats
_GELU_CONSTANTS = {}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`: the tanh approximation. Below float32 it follows
    `jax.nn.gelu` operation by operation, each rounded to x's dtype with
    constants rounded to it first (`F.gelu` rounds once, and differs in
    ~40% of bf16 outputs by an ulp)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    if x.dtype not in _GELU_CONSTANTS:
        _GELU_CONSTANTS[x.dtype] = tuple(
            float(torch.tensor(v, dtype=x.dtype))
            for v in (math.sqrt(2 / math.pi), 0.044715))
    scale, cubic = _GELU_CONSTANTS[x.dtype]
    inner = scale * (x + cubic * x ** 3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


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
    (the JAX package's `jax.image.resize(method="linear")`): output 2i
    blends x[i-1] and x[i] by 1/4 and 3/4, output 2i+1 x[i] and x[i+1],
    the edges clamped. Below float32 the blends are written out, in
    float32 and rounded once, which is bit for bit what F.interpolate
    computes; their backward needs no atomic adds, where the backward of
    F.interpolate on a bf16 CUDA tensor accumulates with them (71 ms a
    step at B=128 on an H100, against 10 ms in float32)."""
    if x.dtype == torch.float32:
        y = F.interpolate(x.transpose(1, 2), size=x.shape[1] * 2,
                          mode="linear", align_corners=False)
        return y.transpose(1, 2)
    xf = x.float()
    prev = torch.cat([xf[:, :1], xf[:, :-1]], dim=1)
    nxt = torch.cat([xf[:, 1:], xf[:, -1:]], dim=1)
    y = torch.stack([0.25 * prev + 0.75 * xf, 0.75 * xf + 0.25 * nxt], dim=2)
    return y.reshape(x.shape[0], 2 * x.shape[1], x.shape[2]).to(x.dtype)


Dtype = Optional[torch.dtype]


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=)`: with a compute dtype, the input, weight and
    bias are cast to it and multiplied in it; None is `nn.Linear`.

    Column-parallel under a 'model' group (`tensor_parallel`, set by
    `train.distributed.shard_dense`: (group, index, count)): the weight
    holds rows [index * n, (index + 1) * n) of the full (out, in) weight,
    n = out / count; each rank multiplies its rows, the ranks' blocks are
    gathered into the full output and the replicated bias is added to it.
    The input's gradient sums over the group (each rank's columns give one
    part of it)."""

    tensor_parallel = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Dtype = None):
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.tensor_parallel is not None:
            group, index, count = self.tensor_parallel
            w = self.weight if dt is None else self.weight.to(dt)
            x = copy_to_group(x if dt is None else x.to(dt), group)
            y = gather_columns(F.linear(x, w), group, index, count)
            if self.bias is None:
                return y
            return y + (self.bias if dt is None else self.bias.to(dt))
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv1d(nn.Conv1d):
    """flax `nn.Conv(dtype=)` without bias over (B, C, S): the input and
    weight cast to the compute dtype; None is `nn.Conv1d`."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dtype: Dtype = None, dilation: int = 1):
        super().__init__(in_features, features, kernel_size, bias=False,
                         dilation=dilation)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=)` (eps 1e-6): with a compute dtype the
    statistics, the normalization, scale and shift run in float32 and the
    output is cast to it; None is `nn.LayerNorm`."""

    def __init__(self, features: int, dtype: Dtype = None):
        super().__init__(features, eps=LAYER_NORM_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        return super().forward(x.float()).to(self.dtype)


class BatchNorm(nn.Module):
    """Batch norm over the last axis with flax `nn.BatchNorm` arithmetic.

    Training mode (`self.training`) normalizes with the fp32 batch mean over
    every other axis and the biased variance E[x^2] - E[x]^2, clipped at 0,
    and updates the running statistics in place as
    `running = BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch` (the
    variance update is biased too). `torch.nn.BatchNorm1d` differs on both
    counts: its momentum weights the batch, and its running variance is
    unbiased. Eval mode normalizes with the running statistics. The
    statistics stay float32; with a compute dtype the normalization runs in
    float32 and the output is cast to it.

    Under a data group (`group`, `group_size`, set by
    `train.distributed.sync_batch_norm`) the training statistics are the
    global batch's: each rank's fp32 [E_local[x], E_local[x^2]] averaged
    over the group (ranks hold equal rows), differentiably, so forward and
    backward equal one process over the concatenated rows and the running
    statistics stay identical on every rank. A group of one computes
    bit for bit what no group computes.
    """

    group = None
    group_size = 1

    def __init__(self, features: int, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            if self.group is None:
                mean, sq = xf.mean(axes), (xf * xf).mean(axes)
            else:
                stats = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
                mean, sq = (all_reduce_sum(stats, self.group)
                            / self.group_size).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                for ra, batch in ((self.running_mean, mean),
                                  (self.running_var, var)):
                    ra.copy_(BN_MOMENTUM * ra + (1 - BN_MOMENTUM) * batch)
        mul = torch.rsqrt(var + BATCH_NORM_EPS) * self.weight
        y = (x - mean) * mul + self.bias
        return y if self.dtype is None else y.to(self.dtype)


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
                 use_skip_connection: bool = True, dtype: Dtype = None):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        self.final_activation = final_activation
        self.activation = activation
        self.use_skip_connection = use_skip_connection
        dims = (in_features,) + hidden_dims
        self.dense = nn.ModuleList(Dense(a, b, dtype=dtype)
                                   for a, b in zip(dims[:-1], dims[1:]))
        n_norm = len(hidden_dims) if final_activation else len(hidden_dims) - 1
        self.norm = nn.ModuleList(LayerNorm(w, dtype) for w in
                                  (in_features,) + hidden_dims[:n_norm])
        self.skip_proj = (Dense(in_features, hidden_dims[-1], dtype=dtype)
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
    leakage. With dilation d the taps are d apart and the left pad is
    (k-1) * d."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dtype: Dtype = None, dilation: int = 1):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.conv = Conv1d(in_features, features, kernel_size, dtype,
                           dilation)

    def forward(self, x: torch.Tensor,
                carry: Optional[torch.Tensor] = None) -> torch.Tensor:
        """carry: the (B, (k-1) d, C) tail of the preceding chunk's input, which
        streaming puts in place of the zero left pad (cast to x's dtype), so
        that chunks in turn give what one full-sequence call gives."""
        if carry is None:
            x = F.pad(x, (0, 0, self.pad, 0))
        else:
            x = torch.cat([carry.to(x.dtype), x], dim=1)
        return _conv_bsc(self.conv, x)


class CausalConvBlock(nn.Module):
    """Causal conv (dilation d) -> BatchNorm -> relu."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dtype: Dtype = None, dilation: int = 1):
        super().__init__()
        self.conv = CausalConv1d(in_features, features, kernel_size, dtype,
                                 dilation)
        self.bn = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor,
                carry: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x, carry)))


class ReflectConvBlock(nn.Module):
    """Optional 2x upsample -> reflect-padded 'same' conv -> BatchNorm ->
    relu. A sequence too short to reflect (S <= p) is edge-padded."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 up_sampling: bool = False, dtype: Dtype = None):
        super().__init__()
        self.up_sampling = up_sampling
        self.pad = (kernel_size - 1) // 2
        self.conv = Conv1d(in_features, features, kernel_size, dtype)
        self.bn = BatchNorm(features, dtype)

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
                     recurrence: Callable = wavefront_recurrence
                     ) -> List[Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Run independent prepared LSTM streams as ONE wavefront recurrence.

    Unit (stream, layer l) at step k computes time t = k - l from its own
    h and from layer l-1's h of step k-1, so every unit of every stream
    advances in the same step: K = S + D - 1 steps in all (D the deepest
    stream), each one product with the packed W_eff.

    `recurrence` is the wavefront recurrence, called as
    recurrence(W_eff, b_packed, xs_wave, h0, c0, lvec, S) -> (h_seq, h_fin,
    c_fin); the default, `kernels.wavefront_recurrence`, dispatches by
    device to the CUDA kernels or their plain versions and differentiates
    through the reverse wavefront. Autograd reaches the per-layer weights
    through the packing (`_wavefront_pack`, `_wavefront_xs` write them into
    slices of zero tensors) and the unpack slices. Returns, per stream,
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
    """Multi-layer unidirectional LSTM over (B, S, C), gate order [i, f, g, o].
    Calling it prepares an LSTMStream (the JAX package's `prepare=True`);
    `run_lstm_streams` runs the recurrence and returns the final state in
    the layout `initial_state` takes, so one call chains into the next.

    Kernels keep the flax layout: w_ih_l (in, 4H), w_hh_l (H, 4H), bias_l
    (4H,), so a flax checkpoint maps over unchanged and the wavefront packs
    exactly as the JAX package does. With a compute dtype the input,
    weights, biases and initial state are cast to it, so the recurrence runs
    on that storage type (the kernels' `*_bf16` entry points).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dtype: Dtype = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
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

    def forward(self, x: torch.Tensor,
                initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None) -> LSTMStream:
        """initial_state: (h, c), each (num_layers, B, H), the state carried
        from a preceding chunk; None starts from zeros (the full-sequence
        convention)."""
        w_ih, w_hh, biases = (self._params("w_ih"), self._params("w_hh"),
                              self._params("bias"))
        if self.dtype is not None:
            x, w_ih, w_hh, biases = (
                x.to(self.dtype), *([w.to(self.dtype) for w in ws]
                                    for ws in (w_ih, w_hh, biases)))
        # hoist layer 0's input projection out of the recurrence
        x_proj = x @ w_ih[0] + biases[0]
        if initial_state is None:
            zeros = (x.new_zeros((x.shape[0], self.hidden_size)),
                     ) * self.num_layers
            init = (zeros, zeros)
        else:
            init = tuple(tuple(s.to(x.dtype).unbind(0))
                         for s in initial_state)
        return LSTMStream(x_proj, w_ih, w_hh, biases, init)
