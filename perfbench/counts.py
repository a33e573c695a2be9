"""The yardstick's arithmetic: the model's FLOPs, the wavefront LSTMs' work,
and the peaks they are held to. Everything is counted from the
configuration's shapes, never from what an implementation launches: H is
the unpadded hidden size, and no packed or padded block is counted.

Peaks of one NVIDIA H100 SXM (dense, at its 700 W limit): float32 work
at 165 TFLOP/s, the rate of three TF32 products each (3xTF32 on the
tensor cores, 495 / 3), the fastest route that keeps float32 accuracy, so
that no float32 implementation can read above 100%; bf16 work at 989
TFLOP/s; HBM at 3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict, Mapping

from .reference.model import DECODER_CONVS, SOURCE_CONVS, TARGET_CONVS, \
    architecture, decoder_up_slots

PEAK_FLOPS = {"fp32": 165e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"fp32": 4, "bf16": 2}


def forward_flops(cfg: Mapping) -> Dict[str, float]:
    """FLOPs (2 per multiply-add) of one window's forward pass, by kind:
    `dense` (every residual MLP; the decoder's heads once per window, the
    rest at each of the S steps), `conv`, `lstm_input` and
    `lstm_recurrent` (every layer's input and recurrent products at each
    of the S steps). Norms, activations and the resampling are not
    counted."""
    S, H, L = cfg["seq_len"], cfg["lstm_hidden_dim"], cfg["lstm_num_layers"]
    out = {"dense": 0.0, "conv": 0.0, "lstm_input": 0.0, "lstm_recurrent": 0.0}
    for name, m in architecture(cfg).items():
        dims = (m["n_in"],) + m["widths"]
        per = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        if m["skip"] and m["n_in"] != m["widths"][-1]:
            per += 2 * m["n_in"] * m["widths"][-1]
        positions = 1 if name in ("decoder.output_mu",
                                  "decoder.output_logvar") else S
        out["dense"] += per * positions
    for k in SOURCE_CONVS:
        out["conv"] += 2 * 32 * 32 * k * S
    for k in TARGET_CONVS:
        out["conv"] += 2 * 2 * 16 * 16 * k * S
    c_in, length = cfg["n_scattering"] + cfg["n_phase"], S
    for (feat, k, _), up in zip(DECODER_CONVS,
                                decoder_up_slots(cfg["decimation_factor"])):
        length *= 2 if up else 1
        out["conv"] += 2 * c_in * feat * k * length
        c_in = feat
    for n_in in (32, 20):                    # source, target streams
        for l in range(L):
            out["lstm_input"] += 2 * (n_in if l == 0 else H) * 4 * H * S
            out["lstm_recurrent"] += 2 * H * 4 * H * S
    return out


def step_flops(cfg: Mapping, batch: int, training: bool) -> float:
    """Model FLOPs of one step (training: forward and backward, 3x the
    forward) or one serving request over `batch` windows."""
    return sum(forward_flops(cfg).values()) * batch * (3 if training else 1)


def wavefront_least_s(cfg: Mapping, batch: int, training: bool) -> float:
    """The least time the card could take for a step's LSTM recurrences,
    both streams: the forward recurrence, and in training also the
    reverse's data products, each the larger of its operations over the
    peak of the storage type and its bytes over HBM's rate.

    Operations: per stream, each layer's recurrent product and each
    deeper layer's input product (the layer-0 input projection is one
    GEMM outside the recurrence), 2 H 4H a row and step, over S steps.
    Bytes, each read or written once, in the storage type:
      forward   the blocks' weights, layer 0's gate inputs (S B 4H), the
                initial and final states (4 L B H); serving writes the top
                layer's outputs (S B H), training every layer's h and c
                sequences (2 L S B H), which the reverse needs;
      reverse   the weights, layer 0's gate inputs, every layer's h and c
                sequences, the top output's cotangent (S B H), the states'
                cotangents (4 L B H); writes every layer's gate
                cotangents (L S B 4H)."""
    prec = cfg["precision"]
    item, peak = ITEMSIZE[prec], PEAK_FLOPS[prec]
    S, H, L, B = cfg["seq_len"], cfg["lstm_hidden_dim"], \
        cfg["lstm_num_layers"], batch
    streams = 2
    blocks = 2 * L - 1
    flops = streams * blocks * 2 * H * 4 * H * B * S
    weights = blocks * H * 4 * H
    states = 4 * L * B * H
    seqs = 2 * L * S * B * H
    fwd = weights + S * B * 4 * H + states + (seqs if training else S * B * H)
    total = max(flops / peak, streams * fwd * item / HBM_BYTES_PER_S)
    if training:
        rev = weights + S * B * 4 * H + seqs + S * B * H + states \
            + L * S * B * 4 * H
        total += max(flops / peak, streams * rev * item / HBM_BYTES_PER_S)
    return total
