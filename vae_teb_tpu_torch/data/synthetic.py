"""Synthetic FHR/UP signal generation and the dataset ETL.

Port of `vae_teb_tpu.data.synthetic`. The generator draws from a
`numpy.random.Generator` in the JAX package's order, so a seed gives the
same windows bit for bit. Signals are physiologically shaped (FHR
baseline 120-150 bpm with LF/MF variability and contraction-coupled
decelerations; UP with 2-5 contractions per window), exercising the
frequency bands the coefficient selection targets.

`build_dataset` / `build_dataset_from_records` are the ETL: windows ->
the phase-scattering transform on the device (only the selected pairs
are computed) -> QC -> HDF5 append, or any other writer given as `write`.
They run on the CUDA card unless `device` names another; a `transform`
passed in keeps its own device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import PhaseScattering1D
from .schema import append_batch, create_initial_hdf5

SAMPLE_RATE_HZ = 4.0


def synthetic_fhr_up(n_samples: int, rng: np.random.Generator,
                     n_windows: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Generate (n_windows, n_samples) FHR and UP traces at 4 Hz."""
    t = np.arange(n_samples) / SAMPLE_RATE_HZ
    fhrs, ups = [], []
    for _ in range(n_windows):
        baseline = rng.uniform(120.0, 150.0)
        # uterine activity: 2-5 contractions per 10 min
        n_contr = rng.integers(2, 6)
        up = rng.uniform(5.0, 12.0) + 2.0 * rng.standard_normal(n_samples)
        duration = n_samples / SAMPLE_RATE_HZ
        centers = rng.uniform(0, duration, n_contr)
        widths = rng.uniform(30.0, 70.0, n_contr)
        amps = rng.uniform(30.0, 70.0, n_contr)
        contraction = np.zeros(n_samples)
        for c, w, a in zip(centers, widths, amps):
            contraction += a * np.exp(-0.5 * ((t - c) / w) ** 2)
        up = up + contraction
        # FHR: baseline + LF/MF variability + contraction-coupled decels
        fhr = np.full(n_samples, baseline)
        for f_lo, f_hi, amp in [(0.04, 0.15, 6.0), (0.15, 0.5, 3.0)]:
            n_comp = 4
            freqs = rng.uniform(f_lo, f_hi, n_comp)
            phases = rng.uniform(0, 2 * np.pi, n_comp)
            amps_v = rng.uniform(0.3, 1.0, n_comp) * amp
            for fq, ph, a in zip(freqs, phases, amps_v):
                fhr += a * np.sin(2 * np.pi * fq * t + ph)
        # late decelerations lagging contractions by ~20 s
        lag = rng.uniform(10.0, 30.0)
        decel_gain = rng.uniform(0.1, 0.5)
        for c, w, a in zip(centers, widths, amps):
            fhr -= decel_gain * a * np.exp(-0.5 * ((t - c - lag) / w) ** 2)
        fhr += 1.5 * rng.standard_normal(n_samples)
        fhrs.append(fhr.astype(np.float32))
        ups.append(np.clip(up, 0, None).astype(np.float32))
    return np.stack(fhrs), np.stack(ups)


def find_flat_regions(signal: np.ndarray, tolerance: float = 1e-3,
                      min_length: int = 20) -> List[Tuple[int, int]]:
    """Runs of consecutive samples whose successive differences stay within
    tolerance, at least min_length long, as (start, end) sample indices
    (inclusive)."""
    if len(signal) < 2:
        return []
    flat = np.abs(np.diff(signal)) <= tolerance
    edges = np.diff(flat.astype(np.int8))
    starts = list(np.where(edges == 1)[0] + 1)
    ends = list(np.where(edges == -1)[0] + 1)
    if flat[0]:
        starts = [0] + starts
    if flat[-1]:
        ends = ends + [len(flat)]
    out = []
    for s, e in zip(starts, ends):
        # run of flat diffs [s, e) covers samples [s, e] inclusive
        if (e - s + 1) >= min_length:
            out.append((s, e))
    return out


def passes_qc(fhr: np.ndarray, up: np.ndarray, weight: np.ndarray,
              min_weight: float = 0.90, flat_tolerance: float = 1e-9
              ) -> bool:
    """Window quality control: mean weight at least min_weight, no flat run
    longer than 480 (FHR) or 1200 (UP) samples, at most 1200 flat samples
    per channel."""
    if float(np.mean(weight)) < min_weight:
        return False
    fhr_flats = find_flat_regions(fhr, tolerance=flat_tolerance)
    up_flats = find_flat_regions(up, tolerance=flat_tolerance)
    fhr_lens = [e - s + 1 for s, e in fhr_flats]
    up_lens = [e - s + 1 for s, e in up_flats]
    if max(fhr_lens, default=0) > 480 or max(up_lens, default=0) > 1200:
        return False
    if sum(fhr_lens) > 1200 or sum(up_lens) > 1200:
        return False
    return True


def _reflect_pad_tail(x: np.ndarray, pad: int) -> np.ndarray:
    """Right-pad by (chained) reflection, for records whose length is not a
    multiple of the window stride. Chained so pad may exceed len(x)-1."""
    while pad > 0:
        p = min(pad, len(x) - 1)
        x = np.concatenate([x, x[-1 - p:-1][::-1]])
        pad -= p
    return x


def window_record(fhr: np.ndarray, up: np.ndarray,
                  window: int = 5760, overlap: float = 0.5,
                  weight: Optional[np.ndarray] = None,
                  decimation: int = 16
                  ) -> Dict[str, np.ndarray]:
    """Block one arbitrary-length record into overlapping fixed windows.

    The record -> windows ingest contract of the JAX package's ETL:
    windows of `window` samples at stride window*(1-overlap), aligned left
    at offset 0, with the tail reflect-padded so the final window is
    full-length.

    weight: optional per-raw-sample validity in [0,1] (length == record);
    windowed alongside and decimated (block mean) to window//decimation —
    the schema's per-sequence-step sample weight. Defaults to ones.

    Returns {"fhr": (n, window), "up": (n, window),
             "weight": (n, window//decimation), "domain_start": (n,)}.
    """
    if fhr.shape != up.shape or fhr.ndim != 1:
        raise ValueError("fhr/up must be equal-length 1-D records")
    if not 0.0 <= overlap < 1.0:
        raise ValueError("overlap must be in [0, 1)")
    L = len(fhr)
    if L < 2:
        raise ValueError("record too short to window")
    stride = max(1, int(round(window * (1.0 - overlap))))
    n = 1 if L <= window else int(np.ceil((L - window) / stride)) + 1
    padded_len = (n - 1) * stride + window
    w_raw = np.ones(L, np.float32) if weight is None else \
        np.asarray(weight, np.float32)
    if len(w_raw) != L:
        raise ValueError("weight must be raw-resolution (len == record)")
    pad = padded_len - L
    fhr_p = _reflect_pad_tail(np.asarray(fhr, np.float32), pad)
    up_p = _reflect_pad_tail(np.asarray(up, np.float32), pad)
    # reflected (synthesized) samples carry zero weight: they are not data
    w_p = np.concatenate([w_raw, np.zeros(pad, np.float32)])
    starts = np.arange(n) * stride
    idx = starts[:, None] + np.arange(window)[None, :]
    len_seq = window // decimation
    w_win = w_p[idx].reshape(n, len_seq, decimation).mean(axis=2)
    return {"fhr": fhr_p[idx], "up": up_p[idx],
            "weight": w_win.astype(np.float32),
            "domain_start": starts.astype(np.float32)}


FIELDS = ("fhr", "up", "fhr_st", "fhr_ph", "fhr_up_ph", "target", "weight",
          "epoch", "cs_label", "bg_label", "guid")


def _transform(transform: Optional[PhaseScattering1D], J: int, Q: int,
               T: int, shape: int, device) -> PhaseScattering1D:
    """The caller's transform, or the exact fp32 frontend on `device` (the
    card unless another is named)."""
    if transform is not None:
        return transform
    return PhaseScattering1D(J=J, Q=Q, T=T, shape=shape, max_order=1,
                             device=resolve_device(device))


class _Writer:
    """The ETL's output: creates the HDF5 file at `path` (unless `write`
    is given) and hands it each record's kept windows in one batch."""

    def __init__(self, path: Optional[str],
                 write: Optional[Callable[[Dict], None]],
                 sc: PhaseScattering1D, len_signal: int, n_phase: int,
                 n_cross: int):
        if write is None:
            create_initial_hdf5(
                path, len_signal=len_signal,
                len_sequence=sc.scattering.n_out,
                channel_counts={"fhr_st": sc.scattering.output_channels,
                                "fhr_ph": n_phase, "fhr_up_ph": n_cross})
            write = lambda batch: append_batch(path, batch)
        self.write = write
        self.discard()

    def add(self, **fields) -> None:
        for k, v in fields.items():
            self.pending[k].append(v)

    def flush(self) -> None:
        if self.pending["fhr"]:
            self.write({k: (v if k == "guid" else np.stack(v))
                        for k, v in self.pending.items()})
        self.discard()

    def discard(self) -> None:
        self.pending = {k: [] for k in FIELDS}


def _coefficients(sc: PhaseScattering1D, fhr: np.ndarray, up: np.ndarray,
                  phase_idx, cross_idx) -> Tuple[np.ndarray, ...]:
    """(scattering, phase, cross-phase) of a batch of raw windows, computed
    on the transform's device: channel 0 = FHR (scattering and the
    acceleration source), channel 1 = UP."""
    fb = torch.as_tensor(fhr, device=sc.device)
    ub = torch.as_tensor(up, device=sc.device)
    out_ph = sc(fb, compute_phase=True, phase_subset=phase_idx)
    out_cr = sc(torch.stack([fb, ub], dim=1), compute_phase=False,
                compute_cross_phase=True, cross_subset=cross_idx,
                compute_scattering=False)
    return tuple(t.cpu().numpy() for t in (out_ph["scattering"],
                                           out_ph["phase_corr"],
                                           out_cr["cross_phase_corr"]))


def _selection(sc: PhaseScattering1D):
    sel = sc.optimal_fhr_selection()
    return (sel["phase_selection"]["selected_indices"],
            sel["cross_selection"]["selected_indices"])


def build_dataset_from_records(path: Optional[str],
                               records,
                               transform: Optional[PhaseScattering1D] = None,
                               J: int = 11, Q: int = 4, T: int = 16,
                               window: int = 5760,
                               overlap: float = 0.5,
                               batch_size: int = 4,
                               pre_defined_target: float = 1.0,
                               min_weight: float = 0.90,
                               device=None,
                               write: Optional[Callable[[Dict], None]] = None
                               ) -> Dict:
    """Record-list ETL: arbitrary-length records -> overlapping windows ->
    the transform on the device -> QC -> HDF5 append at `path` (or, with
    `write`, one call per record with its kept windows, fields stacked and
    guid a list; `path` is then unused).

    records: iterable of dicts with keys
        fhr (L,), up (L,)           raw 4 Hz traces, any equal length L
        weight (L,) optional        per-sample validity, default ones
        guid str optional           record id, default "record_<i>"
        cs_label / bg_label bool    optional, default False

    A record that raises is reported in the returned errors list and
    contributes no window (the JAX package keeps the windows of its
    batches before the failing one); a device fault (CUDA error, out of
    memory) ends the run. epoch stores each window's start offset.
    """
    sc = _transform(transform, J, Q, T, window, device)
    if sc.scattering.N != window:
        raise ValueError(f"transform shape {sc.scattering.N} != window "
                         f"{window}")
    phase_idx, cross_idx = _selection(sc)
    dec = window // sc.scattering.n_out
    out = _Writer(path, write, sc, window, len(phase_idx), len(cross_idx))

    kept = skipped = 0
    errors = []
    for rec_i, rec in enumerate(records):
        guid = rec.get("guid", f"record_{rec_i:04d}")
        counts = (kept, skipped)
        try:
            win = window_record(np.asarray(rec["fhr"]), np.asarray(rec["up"]),
                                window=window, overlap=overlap,
                                weight=rec.get("weight"), decimation=dec)
            fhr_w, up_w, wt_w = win["fhr"], win["up"], win["weight"]
            for start in range(0, len(fhr_w), batch_size):
                sl = slice(start, start + batch_size)
                fb, ub, wb = fhr_w[sl], up_w[sl], wt_w[sl]
                st, ph, cr = _coefficients(sc, fb, ub, phase_idx, cross_idx)
                for i in range(fb.shape[0]):
                    if not passes_qc(fb[i], ub[i], wb[i],
                                     min_weight=min_weight,
                                     flat_tolerance=1e-9):
                        skipped += 1
                        continue
                    out.add(fhr=fb[i], up=ub[i], fhr_st=st[i], fhr_ph=ph[i],
                            fhr_up_ph=cr[i],
                            target=pre_defined_target * wb[i], weight=wb[i],
                            epoch=win["domain_start"][start + i],
                            cs_label=bool(rec.get("cs_label", False)),
                            bg_label=bool(rec.get("bg_label", False)),
                            guid=str(guid))
                    kept += 1
            out.flush()
        except (torch.AcceleratorError, torch.OutOfMemoryError):
            raise   # a device fault is not the record's: every later one fails alike
        except Exception as e:  # per-record isolation
            errors.append({"record": str(guid), "error": repr(e)})
            kept, skipped = counts          # nothing of a failed record stays
            out.discard()
    return {"kept": kept, "skipped": skipped, "errors": errors}


def synthetic_records(n_records: int, record_len: int,
                      seed: int = 0):
    """Yield synthetic long records in the build_dataset_from_records
    ingest format."""
    rng = np.random.default_rng(seed)
    for i in range(n_records):
        fhr, up = synthetic_fhr_up(record_len, rng, 1)
        yield {"fhr": fhr[0], "up": up[0], "guid": f"synthetic_{i:04d}"}


def build_dataset(path: Optional[str],
                  n_records: int = 8,
                  windows_per_record: int = 2,
                  len_signal: int = 5760,
                  seed: int = 0,
                  transform: Optional[PhaseScattering1D] = None,
                  J: int = 11, Q: int = 4, T: int = 16,
                  batch_size: int = 4,
                  pre_defined_target: float = 1.0,
                  cs_label: bool = False,
                  bg_label: bool = False,
                  device=None,
                  write: Optional[Callable[[Dict], None]] = None
                  ) -> Dict[str, int]:
    """A schema-complete dataset of synthetic windows: `n_records` records
    of `windows_per_record` windows each, seeded by `seed`, through the
    transform on the device and the QC, into the HDF5 file at `path` (or
    to `write`, as in build_dataset_from_records). Only the selected
    pairs are computed."""
    rng = np.random.default_rng(seed)
    sc = _transform(transform, J, Q, T, len_signal, device)
    phase_idx, cross_idx = _selection(sc)
    len_seq = sc.scattering.n_out
    out = _Writer(path, write, sc, len_signal, len(phase_idx),
                  len(cross_idx))

    kept = skipped = 0
    for rec in range(n_records):
        fhr, up = synthetic_fhr_up(len_signal, rng, windows_per_record)
        weight = np.ones((windows_per_record, len_seq), np.float32)
        for start in range(0, windows_per_record, batch_size):
            sl = slice(start, min(start + batch_size, windows_per_record))
            fb, ub = fhr[sl], up[sl]
            st, ph, cr = _coefficients(sc, fb, ub, phase_idx, cross_idx)
            for i in range(fb.shape[0]):
                w = weight[sl][i]
                if not passes_qc(fb[i], ub[i], w, flat_tolerance=1e-9):
                    skipped += 1
                    continue
                out.add(fhr=fb[i], up=ub[i], fhr_st=st[i], fhr_ph=ph[i],
                        fhr_up_ph=cr[i], target=pre_defined_target * w,
                        weight=w, epoch=np.float32(rec * 1000 + start + i),
                        cs_label=cs_label, bg_label=bg_label,
                        guid=f"synthetic_{rec:04d}")
                kept += 1
        out.flush()
    return {"kept": kept, "skipped": skipped}
