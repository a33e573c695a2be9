"""The reference's first three training steps, from the seed's weights, the
rows the program stepped on and the noise it was handed.

The fields are normalized as the configuration's statistics say (log on
the scattering channels but the first, asinh on the phase fields, then a
per-channel z-score; the raw FHR z-scored), the forward runs in training
mode, the ELBO is differentiated by autograd, and `AdamW` steps, all in
the precision given (float64 unless a control lowers it).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import weights
from .model import AdamW, Model, elbo, is_buffer
from .precision import Precision

LOG_EPS = 1e-6
Z_EPS = 1e-8


def normalize(rows: Mapping[str, np.ndarray], stats: Mapping, dtype, device):
    """(y_st, y_ph, x_ph) (B, S, C) and y_raw (B, 16 S), normalized."""
    def z(name, x):
        mean = torch.as_tensor(np.asarray(stats[name]["mean"]), dtype=dtype,
                               device=device)
        std = torch.sqrt(torch.as_tensor(np.asarray(stats[name]["variance"]),
                                         dtype=dtype, device=device))
        if x.dim() == 3:
            mean, std = mean[:, None], std[:, None]
        return (x - mean) / (std + Z_EPS)

    t = {k: torch.as_tensor(v, dtype=dtype, device=device)
         for k, v in rows.items()}
    st = t["fhr_st"].clone()
    st[:, 1:] = torch.log(torch.clamp(st[:, 1:], min=0.0) + LOG_EPS)
    return (z("fhr_st", st).transpose(1, 2),
            z("fhr_ph", torch.asinh(t["fhr_ph"])).transpose(1, 2),
            z("fhr_up_ph", torch.asinh(t["fhr_up_ph"])).transpose(1, 2),
            z("fhr", t["fhr"]))


def reference_steps(cfg: Mapping, shapes: Mapping, pool: Mapping[str, np.ndarray],
                    stats: Mapping, rows: Sequence[np.ndarray], seed: int,
                    batch: int, device, precision: Optional[str] = None,
                    fault: Optional[str] = None) -> Dict:
    """{"losses": [3], "grad": {leaf: norm of step 1's clipped gradient},
    "change": {leaf: norm of the parameters' change over three steps}}.

    `fault="half_batch"` plants a fault for calibration: each step's loss
    is the mean over the first half of the rows only."""
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
    model = Model(m, {**params, **bufs}, pol, train=True)
    losses, grad = [], {}
    for step in range(3):
        keep = slice(None) if fault != "half_batch" else slice(0, batch // 2)
        fields = normalize({f: v[rows[step]][keep] for f, v in pool.items()},
                           stats, pol.real, device)
        out = model.forward(*fields[:3], eps=eps[step][keep])
        loss = elbo(out, fields[0], fields[1], fields[3],
                    tc["kld_beta"])["total_loss"]
        for p in params.values():
            p.grad = None
        loss.backward()
        clipped = opt.step()
        losses.append(float(loss.detach()))
        if step == 0:
            grad = {n: float(g.norm()) for n, g in clipped.items()}
        del out, loss, clipped
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in params.items()}
    return {"losses": losses, "grad": grad, "change": change}
