"""The yardstick's arithmetic for the direct-window forecaster
(`SeqVaeTebForecast(decoder_type="direct")`): the model's FLOPs, and the
least time of its decoder LSTM's recurrence, held to the peaks of
`counts.py` (one H100 SXM at 700 W: float32 work at 165 TFLOP/s, HBM at
3.35 TB/s). Everything is counted from the configuration's shapes, never
from what an implementation launches: H is the unpadded hidden size, and
no packed or padded block is counted.
"""

from __future__ import annotations

from typing import Dict, Mapping

from .counts import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS
from .reference.forecast import (DIRECT_CONVS, LSTM_LAYERS,
                                 decoder_architecture)
from .reference.model import SOURCE_CONVS, TARGET_CONVS, architecture

__all__ = ["PEAK_FLOPS", "forward_flops", "step_flops", "grid_least_s"]


def _dense(m) -> int:
    """FLOPs of one residual MLP at one position: its dense layers and its
    skip projection."""
    dims = (m["n_in"],) + m["widths"]
    per = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if m["skip"] and m["n_in"] != m["widths"][-1]:
        per += 2 * m["n_in"] * m["widths"][-1]
    return per


def forward_flops(cfg: Mapping) -> Dict[str, float]:
    """FLOPs (2 per multiply-add) of one window's forward pass, by kind:
    `dense` (every residual MLP, at each of the S steps), `conv`,
    `lstm_input` and `lstm_recurrent` (every layer's input and recurrent
    products at each of the S steps: the encoders' two streams and the
    decoder's stack). Norms, activations, the clip and the loss are not
    counted."""
    S, H, L = cfg["seq_len"], cfg["lstm_hidden_dim"], cfg["lstm_num_layers"]
    Hd, Z = cfg["hidden"], cfg["latent_dim"]
    out = {"dense": 0.0, "conv": 0.0, "lstm_input": 0.0, "lstm_recurrent": 0.0}
    encoders = {k: v for k, v in architecture(cfg).items()
                if not k.startswith("decoder.")}
    for m in list(encoders.values()) + list(decoder_architecture(cfg).values()):
        out["dense"] += _dense(m) * S
    for k in SOURCE_CONVS:
        out["conv"] += 2 * 32 * 32 * k * S
    for k in TARGET_CONVS:
        out["conv"] += 2 * 2 * 16 * 16 * k * S
    c_in = Z
    for k in DIRECT_CONVS:
        out["conv"] += 2 * c_in * Hd * k * S
        c_in = Hd
    for n_in in (32, 20):                    # source, target streams
        for l in range(L):
            out["lstm_input"] += 2 * (n_in if l == 0 else H) * 4 * H * S
            out["lstm_recurrent"] += 2 * H * 4 * H * S
    for l in range(LSTM_LAYERS):             # the decoder's stack
        out["lstm_input"] += 2 * (Z if l == 0 else Hd) * 4 * Hd * S
        out["lstm_recurrent"] += 2 * Hd * 4 * Hd * S
    return out


def step_flops(cfg: Mapping, batch: int) -> float:
    """Model FLOPs of one training step over `batch` windows: forward and
    backward, 3x the forward."""
    return sum(forward_flops(cfg).values()) * batch * 3


def grid_least_s(cfg: Mapping, batch: int) -> float:
    """The least time the card could take for a training step's decoder
    LSTM recurrence (one stream of LSTM_LAYERS layers of `hidden` units):
    the forward, which stores the residuals, and the reverse's data
    products, each the larger of its operations over the peak of the
    storage type and its bytes over HBM's rate.

    Operations: each layer's recurrent product and each deeper layer's
    input product (the layer-0 input projection is one GEMM outside the
    recurrence), 2 H 4H a row and step, over S steps. Bytes, each read or
    written once, in the storage type:
      forward   the blocks' weights, layer 0's gate inputs (S B 4H), the
                initial and final states (4 L B H), every layer's h and c
                sequences (2 L S B H), which the reverse needs;
      reverse   the weights, layer 0's gate inputs, every layer's h and c
                sequences, the top output's cotangent (S B H), the states'
                cotangents (4 L B H); writes every layer's gate
                cotangents (L S B 4H)."""
    prec = cfg["precision"]
    item, peak = ITEMSIZE[prec], PEAK_FLOPS[prec]
    S, H, L, B = cfg["seq_len"], cfg["hidden"], LSTM_LAYERS, batch
    blocks = 2 * L - 1
    flops = blocks * 2 * H * 4 * H * B * S
    weights = blocks * H * 4 * H
    states = 4 * L * B * H
    seqs = 2 * L * S * B * H
    fwd = weights + S * B * 4 * H + states + seqs
    rev = weights + S * B * 4 * H + seqs + S * B * H + states \
        + L * S * B * 4 * H
    return max(flops / peak, fwd * item / HBM_BYTES_PER_S) + \
        max(flops / peak, rev * item / HBM_BYTES_PER_S)
