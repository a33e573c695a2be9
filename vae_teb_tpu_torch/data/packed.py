"""Packed window store: memory-mapped, training-ready ingest (numpy only).

Port of `vae_teb_tpu.data.packed`, with the same manifest and magic
string, so a store that either package builds reads in the other.

`PackedWindowStore.build(dataset, dir)` materializes a dataset once (a
`CombinedHDF5Dataset`, or any object with `__len__`, `read_batch(indices)`,
`stats`, `trim_minutes` and `raw_layout`) into one flat binary file per
field plus a JSON manifest; `PackedWindowStore(dir)` reads it back through
`np.memmap`, a batch being one `np.take` per field. It needs no h5py, so it
is the data source on a machine without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .dataset import Batch

_MANIFEST = "manifest.json"
_MAGIC = "vae_teb_tpu/packed-v1"


class PackedWindowStore:
    """Memory-mapped window store. Iteration mirrors
    `CombinedHDF5Dataset.as_batches` (same shard slicing, shuffle and
    drop_last), yielding `Batch` dicts of fresh arrays."""

    def __init__(self, path: str, fields: Optional[Sequence[str]] = None):
        self.path = path
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        if m.get("magic") != _MAGIC:
            raise ValueError(f"{path} is not a packed window store")
        self.n = int(m["n_windows"])
        self.meta = m
        self._mm: Dict[str, np.ndarray] = {}
        for name, spec in m["fields"].items():
            if fields is not None and name not in fields:
                continue
            shape = (self.n,) + tuple(spec["shape"])
            self._mm[name] = np.memmap(
                os.path.join(path, f"{name}.bin"), mode="r",
                dtype=np.dtype(spec["dtype"]), shape=shape)
        self.guids: Optional[List[str]] = m.get("guids")

    @staticmethod
    def build(dataset, out_dir: str,
              fields: Sequence[str] = ("fhr_st", "fhr_ph", "fhr_up_ph",
                                       "fhr", "target", "weight"),
              batch_size: int = 64) -> "PackedWindowStore":
        """Materialize `dataset`, with whatever trim and normalization it is
        configured for, into `out_dir`, one batch at a time in index order
        (peak memory one batch)."""
        os.makedirs(out_dir, exist_ok=True)
        n = len(dataset)
        manifest = {"magic": _MAGIC, "n_windows": n, "fields": {},
                    "normalized": dataset.stats is not None,
                    "trim_minutes": dataset.trim_minutes,
                    "raw_layout": getattr(dataset, "raw_layout", False)}
        handles: Dict[str, object] = {}
        guids: List[str] = []
        try:
            for start in range(0, n, batch_size):
                batch = dataset.read_batch(range(start,
                                                 min(start + batch_size, n)))
                for name in fields:
                    if name not in batch:
                        continue
                    v = np.ascontiguousarray(batch[name])
                    h = handles.get(name)
                    if h is None:
                        h = open(os.path.join(out_dir, f"{name}.bin"), "wb")
                        handles[name] = h
                        manifest["fields"][name] = {
                            "dtype": v.dtype.str, "shape": list(v.shape[1:])}
                    v.tofile(h)
                if "guid" in batch:
                    guids.extend(batch["guid"])
        finally:
            for h in handles.values():
                h.close()
        if guids:
            manifest["guids"] = guids
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        return PackedWindowStore(out_dir)

    def __len__(self) -> int:
        return self.n

    @property
    def fields(self):
        return tuple(self._mm)

    def read_batch(self, indices) -> Batch:
        idx = np.asarray(indices, dtype=np.int64)
        out = Batch()
        for name, mm in self._mm.items():
            out[name] = np.take(mm, idx, axis=0)
        if self.guids is not None:
            out["guid"] = [self.guids[i] for i in idx]
        return out

    def epoch_indices(self, shuffle: bool, seed: int,
                      shard_index: int = 0, shard_count: int = 1,
                      drop_last: bool = True) -> np.ndarray:
        """Same contract as CombinedHDF5Dataset.epoch_indices."""
        order = (np.random.default_rng(seed).permutation(self.n) if shuffle
                 else np.arange(self.n))
        if shard_count > 1:
            if drop_last:
                order = order[:(self.n // shard_count) * shard_count]
            order = order[shard_index::shard_count]
        return order

    def as_batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                   shard_index: int = 0, shard_count: int = 1,
                   drop_last: bool = True) -> Iterator[Batch]:
        order = self.epoch_indices(shuffle, seed, shard_index, shard_count,
                                   drop_last)
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                return
            yield self.read_batch(chunk)
