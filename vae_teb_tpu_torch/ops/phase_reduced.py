"""Reduced-rate phase-correlation pipeline.

Port of `vae_teb_tpu.ops.phase_reduced`. Every selected pair's conjugate
product is band-limited far below Nyquist: the acceleration maps the
i-band onto the j-band, so the product sits at baseband. The pipeline
therefore runs each pair at the lowest power-of-two decimation that keeps
its measured spectral support alias-free:

  1. PLAN (NumPy, float64, `build_reduced_plan`): measure each filter's
     support at SUPPORT_THRESHOLD relative amplitude, bound each pair's
     product support, and assign it a decimation ds; pairs group by ds.
  2. BAND SYNTHESIS at rate W = N_padded/ds: gather the W-bin window of the
     padded spectrum centred on each band (filter weights and 1/ds folded
     in), then one W-point inverse FFT per group gives the band demodulated
     to baseband.
  3. PAIR MATH at rate W: restore each band's full-rate principal phase
     with an exact integer-mod demodulation ramp, accelerate (p * phase),
     fold the j-side ramp back in, and form the conjugate products.
  4. DECIMATE with one composed dense operator per group (W -> n_out): the
     band-limited reconstruction onto the padded circle, the unpad, the
     reflect pad, the phi low-pass and the frequency-domain decimation, as
     two real GEMMs.

The only approximation is the spectral tail beyond the measured support.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# relative amplitude below which a filter's spectral tail counts as outside
# its support; bounds the pipeline's alias fold-in
SUPPORT_THRESHOLD = 3e-4


@dataclass(frozen=True)
class RateGroup:
    ds: int
    W: int
    # band synthesis: S_g band slots, each (source channel, gather window)
    src: np.ndarray          # (S_g,) int8: 0 = i-side spectrum, 1 = j-side
    gather_idx: np.ndarray   # (S_g, W) int32 bins into the full spectrum
    win_filt: np.ndarray     # (S_g, W) float32 filter window * (1/ds)
    # pair math
    ip: np.ndarray           # (P_g,) slot of the accelerated i-band
    jp: np.ndarray           # (P_g,) slot of the conjugated j-band
    powers: np.ndarray       # (P_g,) float32
    band_ramp: np.ndarray    # (S_g, W) float32 demodulation phase ramp
    # composed decimation operator
    Mr: np.ndarray           # (W, n_out) float32
    Mi: np.ndarray           # (W, n_out) float32
    # output routing
    family: np.ndarray       # (P_g,) int8: 0 = phase, 1 = cross
    pos: np.ndarray          # (P_g,) position within the family's subset


@dataclass(frozen=True)
class ReducedPlan:
    groups: Tuple[RateGroup, ...]
    n_phase: int
    n_cross: int
    n_out: int


def _wrapped_support(filt: np.ndarray, center: int, thr: float
                     ) -> Tuple[int, int]:
    """[lo, hi] support bins (absolute, may be negative or overflow, i.e.
    wrap) of a periodized filter, measured on the window centred at
    `center` so wraparound leakage cannot inflate the interval."""
    n = len(filt)
    rolled = np.roll(filt, n // 2 - center)
    idx = np.where(np.abs(rolled) > thr * np.abs(filt).max())[0]
    return (int(idx.min()) - n // 2 + center,
            int(idx.max()) - n // 2 + center)


def _compose_reconstruction(lt_src: np.ndarray, n_padded: int,
                            pad_left: int, W: int) -> np.ndarray:
    """(W, n_out) complex128: the phi-decimation operator `lt_src` (N, n_out)
    applied after the Dirichlet reconstruction of a W-rate sampling of a
    (-W/2, W/2)-band-limited, N_padded-periodic signal on the unpadded
    slice [pad_left, pad_left + N).

    Equal to `_reconstruction_slice(N, n_padded, pad_left, W).T @ lt_src`
    of the JAX package, with its reconstruction matrix
    U[n, m] = (1/W) sum_k e^{2 pi i k (n - m ds) / n_padded},
    k in [-W/2, W/2), evaluated as two FFTs instead of a dense product:
    the sum over n is an inverse DFT of lt_src placed on the padded
    circle, read at the W kept frequencies, and the sum over k is a
    W-point forward DFT.
    """
    n = lt_src.shape[0]
    placed = np.zeros((n_padded, lt_src.shape[1]), np.complex128)
    placed[pad_left:pad_left + n] = lt_src
    ks = np.concatenate([np.arange(0, W // 2), np.arange(-W // 2, 0)])
    # sum_n e^{+2 pi i k n / n_padded} placed[n]  at k = ks
    spec = n_padded * np.fft.ifft(placed, axis=0)[ks % n_padded]
    # sum_k e^{-2 pi i k m / W} spec[k]; ks mod W is 0..W-1 in order
    return np.fft.fft(spec, axis=0) / W


def build_reduced_plan(sc, phase_subset: Optional[Sequence[int]],
                       cross_subset: Optional[Sequence[int]],
                       thr: float = SUPPORT_THRESHOLD) -> ReducedPlan:
    """Static plan for `apply_reduced`. `sc` is the PhaseScattering1D
    instance (filters, pair table, padding and decimation geometry); `thr`
    the relative amplitude that bounds each filter's support."""
    n_padded = sc.N_padded
    psi = np.asarray(sc.fb.psi1, np.float64)
    phi = np.asarray(sc.fb.phi_levels[0], np.float64)
    xi = sc.center_freqs
    pairs = sc.pairs

    centers = np.asarray(np.rint(xi.astype(np.float64) * n_padded), np.int64)
    sup = [_wrapped_support(psi[b], int(centers[b]), thr)
           for b in range(psi.shape[0])]
    half_phi = int(np.where(np.abs(phi[:n_padded // 2])
                            > thr * phi.max())[0].max()) + 1

    # ---- assign each (family, pair) a decimation group --------------------
    by_ds: Dict[int, List[Tuple]] = {}
    fam_subsets = ((0, phase_subset), (1, cross_subset))
    n_phase = len(phase_subset) if phase_subset is not None else 0
    n_cross = len(cross_subset) if cross_subset is not None else 0
    for family, subset in fam_subsets:
        if subset is None:
            continue
        for pos, k in enumerate(np.asarray(subset)):
            i, j = int(pairs.i_idx[k]), int(pairs.j_idx[k])
            p = float(pairs.powers[k])
            lo_i, hi_i = sup[i]
            lo_j, hi_j = sup[j]
            c_i, c_j = int(centers[i]), int(centers[j])
            delta = p * c_i - c_j
            lo = p * (lo_i - c_i) - (hi_j - c_j) + delta
            hi = p * (hi_i - c_i) - (lo_j - c_j) + delta
            half = max(abs(lo), abs(hi))
            ds = 1
            for d in (16, 8, 4, 2):
                if half < (n_padded // d) / 2 - half_phi - 8:
                    ds = d
                    break
            by_ds.setdefault(ds, []).append((family, pos, i, j, p))

    # ---- build each group --------------------------------------------------
    lt_src = sc.phi_lt_src()                        # (N, n_out) complex128
    n_out = lt_src.shape[1]
    groups = []
    for ds in sorted(by_ds):
        rows = by_ds[ds]
        W = n_padded // ds
        # band slots: (side, band); side 0 = i-spectrum, 1 = j-spectrum
        slots: Dict[Tuple[int, int], int] = {}

        def slot(side: int, band: int) -> int:
            if (side, band) not in slots:
                slots[(side, band)] = len(slots)
            return slots[(side, band)]

        ip, jp, pw, fams, poss = [], [], [], [], []
        for family, pos, i, j, p in rows:
            # the phase family correlates the i-channel with itself; the
            # cross family conjugates the second channel (FHR takes the
            # i-side and the acceleration, UP the j-side)
            ip.append(slot(0, i))
            jp.append(slot(0 if family == 0 else 1, j))
            pw.append(p)
            fams.append(family)
            poss.append(pos)

        S_g = len(slots)
        src = np.zeros(S_g, np.int8)
        gather_idx = np.zeros((S_g, W), np.int32)
        win_filt = np.zeros((S_g, W), np.float32)
        band_ramp = np.zeros((S_g, W), np.float32)
        offs = np.concatenate([np.arange(0, W // 2),
                               np.arange(-W // 2, 0)]).astype(np.int64)
        ms = np.arange(W, dtype=np.int64)
        for (side, band), s in slots.items():
            src[s] = side
            c = int(centers[band])
            bins = (c + offs) % n_padded
            gather_idx[s] = bins.astype(np.int32)
            win_filt[s] = (psi[band][bins] / ds).astype(np.float32)
            # exact integer mod keeps the ramp in [0, 2*pi) at full fp32
            # precision across the window (a naive c*ds*m/N ramp loses
            # ~5e-4 rad by the window end, amplified p-fold)
            band_ramp[s] = (2.0 * np.pi * ((c * ds * ms) % n_padded)
                            / n_padded).astype(np.float32)

        M = _compose_reconstruction(lt_src, n_padded, sc.pad_left, W)
        groups.append(RateGroup(
            ds=ds, W=W, src=src, gather_idx=gather_idx, win_filt=win_filt,
            ip=np.asarray(ip), jp=np.asarray(jp),
            powers=np.asarray(pw, np.float32), band_ramp=band_ramp,
            Mr=np.ascontiguousarray(M.real).astype(np.float32),
            Mi=np.ascontiguousarray(M.imag).astype(np.float32),
            family=np.asarray(fams, np.int8), pos=np.asarray(poss)))

    return ReducedPlan(groups=tuple(groups), n_phase=n_phase,
                       n_cross=n_cross, n_out=n_out)


class _DeviceGroup:
    """One RateGroup's constants as tensors, laid out for `apply_reduced`."""

    def __init__(self, g: RateGroup, n_padded: int,
                 correlation_dtype: Optional[torch.dtype], device):
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
        # one gather from the two spectra laid end to end (i-side, j-side)
        self.flat_idx = t(g.src.astype(np.int64)[:, None] * n_padded
                          + g.gather_idx)
        self.win = t(g.win_filt)
        self.ip, self.jp = t(g.ip), t(g.jp)
        self.powers = t(g.powers[:, None])
        self.ramp = t(g.band_ramp)
        self.ramp_j = t(g.band_ramp[g.jp])
        Mr, Mi = t(g.Mr), t(g.Mi)
        if correlation_dtype is not None:
            # bf16 operands with fp32 accumulation: products of bf16 values
            # are exact in fp32, so an fp32 GEMM of the rounded operands is
            # the low-precision matmul with fp32 accumulate
            Mr = Mr.to(correlation_dtype).float()
            Mi = Mi.to(correlation_dtype).float()
        self.Mr, self.Mi = Mr, Mi


class DevicePlan:
    """A ReducedPlan moved to the device, with the output routing of both
    families precomputed as one index per family."""

    def __init__(self, plan: ReducedPlan, n_padded: int,
                 correlation_dtype: Optional[torch.dtype], device):
        self.host = plan
        self.correlation_dtype = correlation_dtype
        self.groups = [_DeviceGroup(g, n_padded, correlation_dtype, device)
                       for g in plan.groups]
        family = np.concatenate([g.family for g in plan.groups])
        pos = np.concatenate([g.pos for g in plan.groups])
        self.family_index = []
        for fam, total in ((0, plan.n_phase), (1, plan.n_cross)):
            rows = np.where(family == fam)[0]
            if not total:
                self.family_index.append(None)
                continue
            index = np.empty(total, np.int64)
            index[pos[rows]] = rows
            self.family_index.append(torch.as_tensor(index, device=device))


def apply_reduced(plan: DevicePlan, spec_i: torch.Tensor,
                  spec_j: torch.Tensor
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run the reduced-rate pipeline.

    spec_i: full padded complex spectrum (B, N_padded) of the i-side channel
    (FHR); spec_j: of the j-side channel (UP; the FHR spectrum again when
    only the phase family is planned). Returns (phase_corr,
    cross_phase_corr), each (B, P_family, n_out) float32 in subset order,
    None for a family with no pairs.
    """
    dt = plan.correlation_dtype
    spec = torch.cat([spec_i, spec_j], dim=-1)
    outs = []
    for g in plan.groups:
        z = torch.fft.ifft(spec[..., g.flat_idx] * g.win)   # demodulated bands
        mag = z.abs()
        # restore the full-rate principal phase branch: the acceleration
        # below is branch-sensitive for non-integer powers
        ph = torch.angle(z) + g.ramp                       # (-pi, 3*pi)
        ph = torch.where(ph > math.pi, ph - 2 * math.pi, ph)
        # p * principal phase, minus the j-side demodulation ramp (the
        # conjugate contributes e^{-i ramp_j})
        phs = ph[..., g.ip, :] * g.powers - g.ramp_j
        a = mag[..., g.ip, :]
        ar, ai = a * torch.cos(phs), a * torch.sin(phs)
        jr, ji = z.real[..., g.jp, :], z.imag[..., g.jp, :]
        if dt is not None:
            ar, ai, jr, ji = ar.to(dt), ai.to(dt), jr.to(dt), ji.to(dt)
        cr = ar * jr + ai * ji
        ci = ai * jr - ar * ji
        outs.append(cr.float() @ g.Mr - ci.float() @ g.Mi)
    cat = torch.cat(outs, dim=-2)
    pc, cc = (None if idx is None else cat[..., idx, :]
              for idx in plan.family_index)
    return pc, cc
