"""Plain PyTorch versions of the wavefront LSTM recurrences.

The CPU path of `kernels.wavefront.wavefront_fwd` / `wavefront_bwd` and the
oracles that the CUDA kernels (`wavefront_fwd.cu`, `wavefront_bwd.cu`) are
held against on the card. They keep the rounding points of the TPU kernels
they port (`vae_teb_tpu/models/wavefront_pallas.py::_fwd_kernel` and
`::_bwd_kernel`): products read storage-dtype operands and accumulate in
fp32, the cell math runs in fp32, and every carried state (h, c forward;
dh, dc backward) and every stored sequence is rounded to the storage dtype
after each step. float64 storage computes in float64 throughout, for
gradcheck.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _valid_cols(lvec: torch.Tensor, H: int, k: int, S: int) -> torch.Tensor:
    """(UH,) bool: the state columns whose unit (layer lvec[u]) updates at
    step k, i.e. lvec[u] <= k < S + lvec[u]."""
    lcol = lvec.to(torch.int64).repeat_interleave(H)
    return (lcol <= k) & (k < S + lcol)


def wavefront_fwd_plain(W_eff: torch.Tensor, b_packed: torch.Tensor,
                        xs_wave: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, lvec: torch.Tensor, S: int,
                        with_residuals: bool = False,
                        product: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                   torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """K = S + D - 1 wavefront steps over U packed LSTM units.

    W_eff (UH, 4UH), b_packed (4UH,), xs_wave (K, B, 4UH), h0/c0 (B, UH),
    lvec (U,) int layer index of each unit. Column block u of the state
    (unit u, layer lvec[u]) updates only at steps lvec[u] <= k < S +
    lvec[u] and carries its state otherwise. Returns h_seq (K, B, UH),
    h_fin and c_fin (B, UH), all in xs_wave's dtype; with_residuals also
    gates_seq (K, B, 4UH), the pre-activation gates (xs and b included), and
    c_seq (K, B, UH), the carried c after each step, which the backward
    reads. `product(h, W)` stands in for the step's product h @ W (both in
    the compute dtype), for emulating another summation.
    """
    K, B, G = xs_wave.shape
    UH = G // 4
    H = UH // lvec.numel()
    dtype = xs_wave.dtype
    acc = _compute_dtype(dtype)
    w = W_eff.to(acc)
    b = b_packed.to(acc)
    h, c = h0, c0
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=xs_wave.device)
    h_seq = new(K, B, UH)
    if with_residuals:
        gates_seq, c_seq = new(K, B, G), new(K, B, UH)
    for k in range(K):
        hw = h.to(acc) @ w if product is None else product(h.to(acc), w)
        gates = hw + xs_wave[k].to(acc) + b
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c.to(acc) + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        valid = _valid_cols(lvec, H, k, S)
        h = torch.where(valid, h_new.to(dtype), h)
        c = torch.where(valid, c_new.to(dtype), c)
        h_seq[k] = h
        if with_residuals:
            gates_seq[k] = gates
            c_seq[k] = c
    if with_residuals:
        return h_seq, h, c, gates_seq, c_seq
    return h_seq, h, c


def wavefront_bwd_plain(W_eff: torch.Tensor, gates_seq: torch.Tensor,
                        c_seq: torch.Tensor, c_prev_seq: torch.Tensor,
                        dY: torch.Tensor, dh0: torch.Tensor, dc0: torch.Tensor,
                        lvec: torch.Tensor, S: int,
                        product: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                   torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse wavefront, k = K-1 ... 0.

    gates_seq and c_seq come from the residual forward, c_prev_seq is c_seq
    shifted one step (c0 first), dY (K, B, UH) the cotangent of h_seq, and
    dh0/dc0 (B, UH) those of the final states. Per step the activations are
    recomputed from the stored gates, invalid units get zero dgates (but
    keep the feed cotangent of unit v+1, which reaches them through dz, and
    carry dh_tot and dc through), and dz = dgates @ W_eff^T delivers the
    recurrent and the inter-layer cotangents in one product. Returns
    dgates_seq (K, B, 4UH), dh_fin and dc_fin (B, UH), the cotangents of
    xs_wave, h0 and c0, in gates_seq's dtype. `product(dgates, W^T)`
    stands in for the step's product dgates @ W^T, as in the forward.
    """
    K, B, G = gates_seq.shape
    UH = G // 4
    H = UH // lvec.numel()
    dtype = gates_seq.dtype
    acc = _compute_dtype(dtype)
    wt = W_eff.to(acc).t()
    dh, dc = dh0, dc0
    dgates_seq = torch.empty((K, B, G), dtype=dtype, device=gates_seq.device)
    for k in reversed(range(K)):
        dh_tot = dh.to(acc) + dY[k].to(acc)
        dc_c = dc.to(acc)
        i, f, g, o = gates_seq[k].to(acc).chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        tc = torch.tanh(c_seq[k].to(acc))
        do = dh_tot * tc
        dct = dc_c + dh_tot * o * (1.0 - tc * tc)
        cprev = c_prev_seq[k].to(acc)
        dgates = torch.cat([dct * g * i * (1.0 - i),
                            dct * cprev * f * (1.0 - f),
                            dct * i * (1.0 - g * g),
                            do * o * (1.0 - o)], dim=-1)
        valid = _valid_cols(lvec, H, k, S)
        dgates = torch.where(valid.repeat(4), dgates, 0.0).to(dtype)
        dgates_seq[k] = dgates
        dz = (dgates.to(acc) @ wt if product is None
              else product(dgates.to(acc), wt))
        dh = (dz + torch.where(valid, 0.0, dh_tot)).to(dtype)
        dc = torch.where(valid, dct * f, dc_c).to(dtype)
    return dgates_seq, dh, dc
