"""Data: the HDF5 schema, synthetic windows and the ETL, statistics,
normalization, splits, inspection, the HDF5 reader, the packed window
store and prefetch to the device. h5py (and matplotlib, for plots) are
imported only inside the functions that use them."""

from .dataset import (MULTICHANNEL_FIELDS, NORMALIZABLE_FIELDS, Batch,
                      CombinedHDF5Dataset, prefetch_to_device)
from .inspect import describe_hdf5, format_report, plot_sample
from .normalize import (FieldStats, apply_channel_transforms,
                        default_field_stats, denormalize_field,
                        normalize_field, normalize_field_inplace,
                        resolve_channels)
from .packed import PackedWindowStore
from .schema import append_batch, append_sample, create_initial_hdf5, dataset_info
from .splits import create_cv_splits, guid_label_splits
from .stats import DatasetStatsCalculator, load_stats, stats_file_trim_minutes
from .synthetic import (build_dataset, build_dataset_from_records,
                        find_flat_regions, passes_qc, synthetic_fhr_up,
                        synthetic_records, window_record)

__all__ = ["Batch", "CombinedHDF5Dataset", "DatasetStatsCalculator",
           "FieldStats", "MULTICHANNEL_FIELDS", "NORMALIZABLE_FIELDS",
           "PackedWindowStore", "append_batch", "append_sample",
           "apply_channel_transforms", "build_dataset",
           "build_dataset_from_records", "create_cv_splits",
           "create_initial_hdf5", "dataset_info", "default_field_stats",
           "denormalize_field", "describe_hdf5", "find_flat_regions",
           "format_report", "guid_label_splits", "load_stats",
           "normalize_field", "normalize_field_inplace", "passes_qc",
           "plot_sample", "prefetch_to_device", "resolve_channels",
           "stats_file_trim_minutes", "synthetic_fhr_up",
           "synthetic_records", "window_record"]
