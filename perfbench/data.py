"""Inputs made from the seed: training windows in the on-disk layout with
their normalization statistics, and raw FHR / UP windows for serving.

Every seed gives the same sizes; the values differ. Raw windows are FHR
around 140 bpm with slow drift and beat noise, and UP with contractions
(Gaussian bumps of 20-80 mmHg every few minutes) over a 10-20 mmHg tone.
Training windows are made from raw windows of their own as a dataset
build makes them: the plain reference frontend (`reference/frontend.py`,
float64) turns each into the coefficient fields that `cli train` reads,

  fhr_st     (C_st, S)  the trimmed scattering family (channel 0 the
                        low-passed FHR, the others positive moduli)
  fhr_ph     (C_ph, S)  the trimmed phase family
  fhr_up_ph  (C_up, S)  the trimmed cross family
  fhr        (T S,)     the raw FHR over the same trimmed stretch

and the statistics are the pool's own: per channel the mean and variance
of each field after its transform (log on the scattering channels but
the first, asinh on the phase fields), over windows and steps.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")
LOG_EPS = 1e-6
TRAIN_SALT = 1000          # raw windows of the training pool: salts 1000+
BLOCK = 128                # windows through the reference frontend at once


def coefficient_pool(cfg: Mapping, n: int, seed: int, device
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict]]:
    """(pool, stats): `n` windows per field, float32 on the host,
    (n, C, S) or (n, T S); stats {field: {"mean": (C,) or (), "variance":
    ...}}. `cfg` is a configuration (its `model` and `frontend`)."""
    from .reference.frontend import Frontend
    m, fe = cfg["model"], cfg["frontend"]
    front = Frontend(fe["J"], fe["Q"], fe["T"], fe["N"], fe["trim"], device)
    cut = fe["trim"] * fe["T"]
    fields = {f: [] for f in FIELDS}
    for b, start in enumerate(range(0, n, BLOCK)):
        fhr, up = raw_windows(min(BLOCK, n - start), fe["N"], seed,
                              TRAIN_SALT + b)
        coeffs = front(torch.as_tensor(fhr), torch.as_tensor(up))
        for f, c in zip(FIELDS, coeffs):
            fields[f].append(c.transpose(1, 2).float().cpu().numpy())
        fields["fhr"].append(fhr[:, cut:fe["N"] - cut])
    pool = {f: np.ascontiguousarray(np.concatenate(v)) for f, v in
            fields.items()}
    want = {"fhr_st": (n, m["n_scattering"], m["seq_len"]),
            "fhr_ph": (n, m["n_phase"], m["seq_len"]),
            "fhr_up_ph": (n, m["input_channels"], m["seq_len"]),
            "fhr": (n, m["seq_len"] * m["decimation_factor"])}
    got = {f: pool[f].shape for f in FIELDS}
    if got != want:
        raise ValueError(f"the frontend's fields {got} do not fit the "
                         f"model's {want}")
    return pool, pool_stats(pool)


def pool_stats(pool: Mapping[str, np.ndarray]) -> Dict[str, Dict]:
    """Each field's per-channel mean and variance after its transform, in
    float64 over windows and steps; the raw FHR's over everything."""
    st = pool["fhr_st"].astype(np.float64)
    st[:, 1:] = np.log(np.clip(st[:, 1:], 0.0, None) + LOG_EPS)
    out = {}
    for f, x in (("fhr_st", st),
                 ("fhr_ph", np.arcsinh(pool["fhr_ph"].astype(np.float64))),
                 ("fhr_up_ph",
                  np.arcsinh(pool["fhr_up_ph"].astype(np.float64)))):
        out[f] = {"mean": x.mean((0, 2)).astype(np.float32),
                  "variance": x.var((0, 2)).astype(np.float32)}
    fhr = pool["fhr"].astype(np.float64)
    out["fhr"] = {"mean": np.float32(fhr.mean()),
                  "variance": np.float32(fhr.var())}
    return out


def batch_order(pool_size: int, batch: int, seed: int):
    """Row indices of successive batches: each pass over the pool a new
    seeded permutation cut into pool_size // batch disjoint batches."""
    rng = np.random.default_rng([int(seed), 2])
    while True:
        perm = rng.permutation(pool_size)
        for i in range(pool_size // batch):
            yield np.sort(perm[i * batch:(i + 1) * batch])


def raw_windows(n: int, length: int, seed: int, salt: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(fhr, up), each (n, length) float32 at 4 Hz."""
    rng = np.random.default_rng([int(seed), 3, int(salt)])
    t = np.arange(length, dtype=np.float32)
    # FHR: baseline, a slow drift (a random walk smoothed over ~1 minute),
    # beat-to-beat noise
    walk = np.cumsum(rng.standard_normal((n, length), dtype=np.float32), -1)
    kernel = np.ones(240, np.float32) / 240.0
    drift = np.stack([np.convolve(w, kernel, mode="same") for w in walk])
    fhr = (rng.uniform(120, 160, (n, 1)).astype(np.float32) + 0.3 * drift
           + 3.0 * rng.standard_normal((n, length), dtype=np.float32))
    # UP: tone plus contractions every 2-5 minutes
    up = rng.uniform(10, 20, (n, 1)).astype(np.float32) + \
        rng.standard_normal((n, length), dtype=np.float32)
    for row in range(n):
        start = rng.uniform(0, 600)
        centres = np.arange(start, length, rng.uniform(480, 1200))
        for c in centres:
            up[row] += rng.uniform(20, 80) * np.exp(
                -0.5 * ((t - c) / rng.uniform(60, 120)) ** 2)
    return fhr.astype(np.float32), up.astype(np.float32)
