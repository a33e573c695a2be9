"""HDF5 dataset schema: creation, append, batched append.

Port of `vae_teb_tpu.data.schema`, the same on-disk contract, so a file
either package writes reads in the other:

  fhr       (N, len_signal)        f4   raw FHR window
  up        (N, len_signal)        f4   raw uterine-pressure window
  fhr_st    (N, 43, len_sequence)  f4   scattering coefficients
  fhr_ph    (N, 44, len_sequence)  f4   selected phase coefficients
  fhr_up_ph (N, 130, len_sequence) f4   selected cross-phase coefficients
  target    (N, len_sequence)      f4
  weight    (N, len_sequence)      f4
  epoch     (N,)                   f4
  cs_label  (N,)                   u1
  bg_label  (N,)                   u1
  guid      (N,)                   vlen utf-8

All resizable on axis 0, per-sample chunked, LZF-compressed. h5py is
imported inside the functions, so the package imports without it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

FIELD_SHAPES = {
    "fhr_st": 43,
    "fhr_ph": 44,
    "fhr_up_ph": 130,
}
SAMPLE_FIELDS = ("fhr", "up", "fhr_st", "fhr_ph", "fhr_up_ph",
                 "target", "weight", "epoch", "cs_label", "bg_label", "guid")


def create_initial_hdf5(path: str, len_signal: int,
                        len_sequence: int = 360,
                        channel_counts: Optional[Dict[str, int]] = None) -> None:
    """Create an empty resizable dataset file (overwrites existing).

    Datasets are built at the pre-trim resolution (len_sequence=360);
    trimming to 300 steps is the loader's concern.
    """
    import h5py
    counts = dict(FIELD_SHAPES)
    if channel_counts:
        counts.update(channel_counts)
    try:
        os.remove(path)
    except OSError:
        pass
    str_dt = h5py.string_dtype(encoding="utf-8")
    with h5py.File(path, "w", libver="latest") as f:
        for name in ("fhr", "up"):
            f.create_dataset(name, shape=(0, len_signal),
                             maxshape=(None, len_signal), dtype="f4",
                             chunks=(1, len_signal), compression="lzf")
        for name, c in counts.items():
            f.create_dataset(name, shape=(0, c, len_sequence),
                             maxshape=(None, c, len_sequence), dtype="f4",
                             chunks=(1, c, len_sequence), compression="lzf")
        for name in ("target", "weight"):
            f.create_dataset(name, shape=(0, len_sequence),
                             maxshape=(None, len_sequence), dtype="f4",
                             chunks=(1, len_sequence), compression="lzf")
        f.create_dataset("epoch", shape=(0,), maxshape=(None,), dtype="f4",
                         chunks=(1,), compression="lzf")
        f.create_dataset("cs_label", shape=(0,), maxshape=(None,), dtype="u1",
                         chunks=(1,), compression="lzf")
        f.create_dataset("bg_label", shape=(0,), maxshape=(None,), dtype="u1",
                         chunks=(1,), compression="lzf")
        f.create_dataset("guid", shape=(0,), maxshape=(None,), dtype=str_dt,
                         chunks=(1,))


def append_sample(path: str, **fields) -> None:
    """Append one sample (field name -> array/scalar). Resizes by +1."""
    append_batch(path, {k: np.asarray(v)[None, ...] if k != "guid" else [v]
                        for k, v in fields.items()})


def append_batch(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Append a batch of samples in one resize."""
    import h5py
    sizes = {len(v) for v in fields.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes: { {k: len(v) for k, v in fields.items()} }")
    n_new = sizes.pop()
    with h5py.File(path, "a", libver="latest") as f:
        idx = f["fhr"].shape[0]
        new_size = idx + n_new
        for name, ds in f.items():
            ds.resize((new_size,) + ds.shape[1:])
        for name, value in fields.items():
            if name == "guid":
                for k, g in enumerate(value):
                    f["guid"][idx + k] = g
            elif name in ("cs_label", "bg_label"):
                f[name][idx:new_size] = np.asarray(value, dtype=np.uint8)
            else:
                f[name][idx:new_size] = np.asarray(value, dtype=np.float32)


def dataset_info(path: str) -> Dict[str, tuple]:
    """Shapes of every dataset in the file."""
    import h5py
    with h5py.File(path, "r") as f:
        return {k: tuple(f[k].shape) for k in f.keys()}
