"""Plain PyTorch version of the forward wavefront LSTM recurrence.

The CPU path of `kernels.wavefront.wavefront_fwd` and the oracle that the
CUDA kernel (`wavefront_fwd.cu`) is held against on the card. It keeps the
rounding points of the TPU kernel it ports
(`vae_teb_tpu/models/wavefront_pallas.py::_fwd_kernel`): the gate matmul
reads storage-dtype h and W and accumulates in fp32, xs and b are added in
fp32, the cell math runs in fp32, and h and c are stored back in the
storage dtype after every step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def wavefront_fwd_plain(W_eff: torch.Tensor, b_packed: torch.Tensor,
                        xs_wave: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, lvec: torch.Tensor, S: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K = S + D - 1 wavefront steps over U packed LSTM units.

    W_eff (UH, 4UH), b_packed (4UH,), xs_wave (K, B, 4UH), h0/c0 (B, UH),
    lvec (U,) int layer index of each unit. Column block u of the state
    (unit u, layer lvec[u]) updates only at steps lvec[u] <= k < S +
    lvec[u] and carries its state otherwise. Returns h_seq (K, B, UH),
    h_fin and c_fin (B, UH), all in xs_wave's dtype.
    """
    K, B, G = xs_wave.shape
    UH = G // 4
    H = UH // lvec.numel()
    dtype = xs_wave.dtype
    w = W_eff.float()
    b = b_packed.float()
    lcol = lvec.to(torch.int64).repeat_interleave(H)          # (UH,)
    h, c = h0, c0
    h_seq = torch.empty((K, B, UH), dtype=dtype, device=xs_wave.device)
    for k in range(K):
        gates = h.float() @ w + xs_wave[k].float() + b
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c.float() + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        valid = (lcol <= k) & (k < S + lcol)
        h = torch.where(valid, h_new.to(dtype), h)
        c = torch.where(valid, c_new.to(dtype), c)
        h_seq[k] = h
    return h_seq, h, c
