"""Data: normalization, statistics files, the HDF5 reader, the packed
window store and prefetch to the device. h5py is imported only inside the
functions that read HDF5 files."""

from .dataset import (MULTICHANNEL_FIELDS, NORMALIZABLE_FIELDS, Batch,
                      CombinedHDF5Dataset, prefetch_to_device)
from .normalize import (FieldStats, apply_channel_transforms,
                        default_field_stats, denormalize_field,
                        normalize_field, normalize_field_inplace,
                        resolve_channels)
from .packed import PackedWindowStore
from .stats import load_stats, stats_file_trim_minutes

__all__ = ["Batch", "CombinedHDF5Dataset", "FieldStats",
           "MULTICHANNEL_FIELDS", "NORMALIZABLE_FIELDS", "PackedWindowStore",
           "apply_channel_transforms", "default_field_stats",
           "denormalize_field", "load_stats", "normalize_field",
           "normalize_field_inplace", "prefetch_to_device",
           "resolve_channels", "stats_file_trim_minutes"]
