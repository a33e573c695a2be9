"""Field normalization: log/asinh transforms and per-channel z-scoring.

Port of `vae_teb_tpu.data.normalize`. Each function takes a numpy array
(the host loader's path) or a torch tensor (the trainer's in-step path,
`Trainer(normalize_stats=...)`, on the tensor's device) and computes in
that library, as the JAX package picks numpy or jnp by the input's type.

  fhr / up           (x - mean) / (std + 1e-8), scalar stats
  fhr_st             log(clip(x, 0) + log_eps) on channels 1..C-1,
                     channel 0 raw; then per-channel z-score
  fhr_ph / fhr_up_ph asinh on every channel; then per-channel z-score

The numpy half is a copy of the JAX package's (this package imports none
of it); `tests/test_torch_data.py` pins it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

EPS = 1e-8
DEFAULT_LOG_EPSILON = 1e-6

# the production schema's channel-transform assignment
DEFAULT_LOG_CONFIG: Dict[str, object] = {"fhr_st": "all_except_0"}
DEFAULT_ASINH_CONFIG: Dict[str, object] = {"fhr_ph": "all", "fhr_up_ph": "all"}
SCALAR_FIELDS = ("fhr", "up")


def resolve_channels(config_value, n_channels: int) -> np.ndarray:
    """Expand 'all' / 'all_except_0' / explicit index lists to an index array."""
    if config_value == "all":
        return np.arange(n_channels)
    if config_value == "all_except_0":
        return np.arange(1, n_channels)
    if config_value is None:
        return np.zeros(0, dtype=np.int64)
    return np.asarray(list(config_value), dtype=np.int64)


@dataclass(frozen=True)
class FieldStats:
    """Normalization statistics and transform assignment for one field."""
    mean: np.ndarray          # () for scalar fields, (C,) otherwise
    variance: np.ndarray
    log_channels: Tuple[int, ...] = ()
    asinh_channels: Tuple[int, ...] = ()
    log_epsilon: float = DEFAULT_LOG_EPSILON
    count: int = 0

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)


def _channel_choice(n_channels: int, log_channels, asinh_channels
                    ) -> np.ndarray:
    """Per channel: 0 raw, 1 log, 2 asinh."""
    choice = np.zeros(n_channels, dtype=np.int32)
    choice[list(log_channels)] = 1
    choice[list(asinh_channels)] = 2
    return choice


def _broadcast(values: np.ndarray, data, channel_axis: int):
    """`values` (C,) as data's type and dtype, shaped to broadcast along
    channel_axis."""
    shape = [1] * data.ndim
    shape[channel_axis] = data.shape[channel_axis]
    if isinstance(data, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(values))
        if data.is_cuda:   # from pinned memory, so the host does not wait
            t = t.pin_memory().to(data.device, non_blocking=True)
        return t.to(device=data.device,
                    dtype=data.dtype if values.dtype.kind == "f"
                    else torch.int32).reshape(shape)
    return np.asarray(values, dtype=data.dtype if values.dtype.kind == "f"
                      else values.dtype).reshape(shape)


def apply_channel_transforms(data, log_channels: Sequence[int],
                             asinh_channels: Sequence[int],
                             log_epsilon: float, channel_axis: int = -2):
    """Apply log / asinh to the selected channels of (..., C, S) data (by
    default), as per-channel selects."""
    choice = _channel_choice(data.shape[channel_axis], log_channels,
                             asinh_channels)
    if not choice.any():
        return data
    sel = _broadcast(choice, data, channel_axis)
    if isinstance(data, torch.Tensor):
        logged = torch.log(torch.clamp(data, min=0.0) + log_epsilon)
        return torch.where(sel == 1, logged,
                           torch.where(sel == 2, torch.asinh(data), data))
    logged = np.log(np.clip(data, 0.0, None) + log_epsilon)
    return np.where(sel == 1, logged, np.where(sel == 2, np.arcsinh(data), data))


def field_normalizer(field_name: str, stats: FieldStats, like: torch.Tensor,
                     channel_axis: int = -2
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`normalize_field` for tensors of `like`'s device, dtype, rank and
    channel count, as a function whose statistics and channel masks were
    copied to the device once, here: calling it copies nothing from the
    host (so a CUDA graph can hold it). Its arithmetic is normalize_field's,
    which calls it for tensors."""
    if field_name in SCALAR_FIELDS:
        mean, scale = float(stats.mean), float(stats.std) + EPS
        return lambda x: (x - mean) / scale
    choice = _channel_choice(like.shape[channel_axis], stats.log_channels,
                             stats.asinh_channels)
    sel = _broadcast(choice, like, channel_axis)
    is_log, is_asinh = sel == 1, sel == 2
    mean = _broadcast(np.asarray(stats.mean), like, channel_axis)
    scale = _broadcast(np.asarray(stats.std), like, channel_axis) + EPS
    log_epsilon, transform = stats.log_epsilon, bool(choice.any())

    def normalize(x: torch.Tensor) -> torch.Tensor:
        if transform:    # apply_channel_transforms
            logged = torch.log(torch.clamp(x, min=0.0) + log_epsilon)
            x = torch.where(is_log, logged,
                            torch.where(is_asinh, torch.asinh(x), x))
        return (x - mean) / scale
    return normalize


def normalize_field(data, field_name: str, stats: FieldStats,
                    channel_axis: int = -2):
    """Normalize one field with precomputed stats. Scalar fields: z-score.
    Multichannel fields ((..., C, S) by default): channel transforms, then
    the per-channel z-score."""
    if isinstance(data, torch.Tensor):
        return field_normalizer(field_name, stats, data, channel_axis)(data)
    if field_name in SCALAR_FIELDS:
        return (data - float(stats.mean)) / (float(stats.std) + EPS)
    x = apply_channel_transforms(data, stats.log_channels,
                                 stats.asinh_channels, stats.log_epsilon,
                                 channel_axis)
    mean = _broadcast(np.asarray(stats.mean), data, channel_axis)
    std = _broadcast(np.asarray(stats.std), data, channel_axis)
    return (x - mean) / (std + EPS)


def _contiguous_range(channels: Sequence[int]) -> Optional[Tuple[int, int]]:
    if len(channels) == 0:
        return (0, 0)
    a = np.asarray(channels)
    if len(a) == 1 or (np.diff(np.sort(a)) == 1).all():
        return int(a.min()), int(a.max()) + 1
    return None


def normalize_field_inplace(data: np.ndarray, field_name: str,
                            stats: FieldStats,
                            channel_axis: int = -2) -> np.ndarray:
    """The host loader's path: `normalize_field` on a float ndarray the
    caller owns, in place, with sliced in-place ufuncs where the transform
    assignments are contiguous channel ranges (the production schema's),
    and through `normalize_field` otherwise."""
    if field_name in SCALAR_FIELDS:
        data -= float(stats.mean)
        data /= float(stats.std) + EPS
        return data
    log_r = _contiguous_range(stats.log_channels)
    asinh_r = _contiguous_range(stats.asinh_channels)
    if log_r is None or asinh_r is None:
        return np.asarray(normalize_field(data, field_name, stats,
                                          channel_axis))

    def chan_slice(lo: int, hi: int) -> Tuple[slice, ...]:
        sl = [slice(None)] * data.ndim
        sl[channel_axis] = slice(lo, hi)
        return tuple(sl)

    if log_r[1] > log_r[0]:
        v = data[chan_slice(*log_r)]
        np.clip(v, 0.0, None, out=v)
        v += stats.log_epsilon
        np.log(v, out=v)
    if asinh_r[1] > asinh_r[0]:
        v = data[chan_slice(*asinh_r)]
        np.arcsinh(v, out=v)
    shape = [1] * data.ndim
    shape[channel_axis] = data.shape[channel_axis]
    data -= stats.mean.reshape(shape).astype(data.dtype, copy=False)
    data /= stats.std.reshape(shape).astype(data.dtype, copy=False) + EPS
    return data


def denormalize_field(data, field_name: str, stats: FieldStats,
                      channel_axis: int = -2):
    """Invert `normalize_field`, channel transforms included."""
    if field_name in SCALAR_FIELDS:
        return data * (float(stats.std) + EPS) + float(stats.mean)
    mean = _broadcast(np.asarray(stats.mean), data, channel_axis)
    std = _broadcast(np.asarray(stats.std), data, channel_axis)
    x = data * (std + EPS) + mean
    choice = _channel_choice(data.shape[channel_axis], stats.log_channels,
                             stats.asinh_channels)
    if not choice.any():
        return x
    sel = _broadcast(choice, data, channel_axis)
    if isinstance(data, torch.Tensor):
        return torch.where(sel == 1, torch.exp(x) - stats.log_epsilon,
                           torch.where(sel == 2, torch.sinh(x), x))
    return np.where(sel == 1, np.exp(x) - stats.log_epsilon,
                    np.where(sel == 2, np.sinh(x), x))


def default_field_stats(field_name: str, mean, variance,
                        n_channels: Optional[int] = None,
                        log_epsilon: float = DEFAULT_LOG_EPSILON) -> FieldStats:
    """FieldStats with the production transform assignment."""
    mean = np.asarray(mean, dtype=np.float32)
    variance = np.asarray(variance, dtype=np.float32)
    if field_name in SCALAR_FIELDS:
        return FieldStats(mean=mean, variance=variance,
                          log_epsilon=log_epsilon)
    n = n_channels if n_channels is not None else len(mean)
    log_ch = tuple(resolve_channels(DEFAULT_LOG_CONFIG.get(field_name), n))
    asinh_ch = tuple(resolve_channels(DEFAULT_ASINH_CONFIG.get(field_name), n))
    return FieldStats(mean=mean, variance=variance,
                      log_channels=log_ch, asinh_channels=asinh_ch,
                      log_epsilon=log_epsilon)
