"""Host-side reading of HDF5 window datasets, and prefetch to the device.

Port of the read side of `vae_teb_tpu.data.dataset`: `CombinedHDF5Dataset`
with the JAX package's filters, trim, host normalization, layouts and
batched reads (h5py is imported inside the functions that read, so the
package imports on a machine without it), and `prefetch_to_device`, which
stages batches onto the card ahead of the step: pinned host tensors copied
with `non_blocking=True` on a side CUDA stream, each batch carrying an
event that the consuming stream waits on.
"""

from __future__ import annotations

import os
import threading
import warnings
from queue import Empty, Queue
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .normalize import (SCALAR_FIELDS, FieldStats, normalize_field,
                        normalize_field_inplace)
from .stats import load_stats, stats_file_trim_minutes

MULTICHANNEL_FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph")
NORMALIZABLE_FIELDS = SCALAR_FIELDS + MULTICHANNEL_FIELDS


class Batch(dict):
    """Dict with attribute-style access (batch.fhr_st etc.)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


class CombinedHDF5Dataset:
    """Multi-file HDF5 dataset with filtering, trimming and normalization,
    as the JAX package's: the same constructor, filters, per-sample and
    batched processing, and epoch order.

    raw_layout=True keeps multichannel fields in their on-disk (C, S)
    layout; with normalize_fields=() the host then only reads bytes, and
    `Trainer(normalize_stats=...)` normalizes and transposes on the device.
    """

    def __init__(self, paths, load_fields: Optional[Sequence[str]] = None,
                 allowed_guids: Optional[Sequence[str]] = None,
                 cs_label: Optional[bool] = None,
                 bg_label: Optional[bool] = None,
                 epoch_min: Optional[float] = None,
                 epoch_max: Optional[float] = None,
                 label: Optional[int] = None,
                 cache_size: int = 2000,
                 dtype=np.float32,
                 stats_path: Optional[str] = None,
                 normalize_fields: Optional[Sequence[str]] = None,
                 trim_minutes: Optional[float] = None,
                 sample_rate_hz: float = 4.0,
                 decimation: int = 16,
                 allow_stats_trim_mismatch: bool = False,
                 raw_layout: bool = False):
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.load_fields = None if load_fields is None else set(load_fields)
        self.allowed_guids = set(allowed_guids) if allowed_guids else None
        self.cs_label = cs_label
        self.bg_label = bg_label
        self.epoch_min = epoch_min
        self.epoch_max = epoch_max
        self.label = label
        self.cache_size = cache_size
        self.dtype = dtype
        self.normalize_fields = (set(normalize_fields)
                                 if normalize_fields is not None else None)
        self.raw_layout = raw_layout
        self.trim_minutes = trim_minutes
        if trim_minutes is not None:
            self.trim_raw = int(sample_rate_hz * 60 * trim_minutes)
            self.trim_dec = self.trim_raw // decimation
        else:
            self.trim_raw = 0
            self.trim_dec = 0

        self._handles: List[Optional[object]] = [None] * len(self.paths)
        self._locks = [threading.Lock() for _ in self.paths]
        self._cache: Dict[int, Batch] = {}
        self._cache_lock = threading.Lock()
        self.index_map: List[Tuple[int, int]] = []

        self.stats: Optional[Dict[str, FieldStats]] = None
        if stats_path is not None:
            if os.path.exists(stats_path):
                self.stats = load_stats(stats_path)
                stats_trim = stats_file_trim_minutes(stats_path)
                declared = trim_minutes if trim_minutes is not None else -1.0
                # statistics over another window would mis-normalize
                if stats_trim != declared and not allow_stats_trim_mismatch:
                    raise ValueError(
                        f"stats file trim_minutes={stats_trim} != dataset "
                        f"trim_minutes={declared}; stats were computed over a "
                        "different window — pass allow_stats_trim_mismatch="
                        "True to override")
            else:
                warnings.warn(f"stats file not found: {stats_path}; "
                              "normalization disabled")

        self._build_index()
        if not self.index_map:
            raise ValueError("No samples match the specified filters.")

    def _build_index(self) -> None:
        import h5py
        for fidx, path in enumerate(self.paths):
            if not os.path.exists(path):
                warnings.warn(f"HDF5 file not found: {path}")
                continue
            with h5py.File(path, "r", libver="latest") as f:
                guids = f["guid"][()]
                epochs = f["epoch"][()]
                cs = f["cs_label"][()]
                bg = f["bg_label"][()]
                ok = np.ones(len(guids), dtype=bool)
                if self.epoch_min is not None:
                    ok &= epochs >= self.epoch_min
                if self.epoch_max is not None:
                    ok &= epochs <= self.epoch_max
                if self.cs_label is not None:
                    ok &= cs == self.cs_label
                if self.bg_label is not None:
                    ok &= bg == self.bg_label
                for i in np.where(ok)[0]:
                    g = (guids[i].decode() if isinstance(guids[i], bytes)
                         else str(guids[i]))
                    if self.allowed_guids and g not in self.allowed_guids:
                        continue
                    if (self.label is not None
                            and not np.any(f["target"][i] == self.label)):
                        continue
                    self.index_map.append((fidx, int(i)))

    def __len__(self) -> int:
        return len(self.index_map)

    def _open(self, file_idx: int):
        import h5py
        with self._locks[file_idx]:
            if self._handles[file_idx] is None:
                try:
                    self._handles[file_idx] = h5py.File(
                        self.paths[file_idx], "r", libver="latest", swmr=True,
                        rdcc_nbytes=128 * 1024 ** 2, rdcc_nslots=10007,
                        rdcc_w0=0.75)
                except (OSError, ValueError):   # not openable in SWMR mode
                    self._handles[file_idx] = h5py.File(
                        self.paths[file_idx], "r", libver="latest")
            return self._handles[file_idx]

    def close(self) -> None:
        for i, lock in enumerate(self._locks):
            with lock:
                if self._handles[i] is not None:
                    try:
                        self._handles[i].close()
                    finally:
                        self._handles[i] = None

    def _trim_field(self, name: str, data: np.ndarray) -> np.ndarray:
        if self.trim_minutes is None:
            return data
        if name in SCALAR_FIELDS:
            t = self.trim_raw
            return data[..., t:-t] if t else data
        if name in MULTICHANNEL_FIELDS + ("target", "weight"):
            t = self.trim_dec
            if name in ("target", "weight"):
                return data[..., t:-t] if t else data
            return data[..., :, t:-t] if t else data
        return data

    def _wants_norm(self, name: str) -> bool:
        return (self.stats is not None and name in self.stats
                and name in NORMALIZABLE_FIELDS
                and (self.normalize_fields is None
                     or name in self.normalize_fields))

    def _process_field(self, name: str, data: np.ndarray) -> np.ndarray:
        data = self._trim_field(name, data).astype(self.dtype)
        if self._wants_norm(name):
            data = np.asarray(normalize_field(
                data, name, self.stats[name],
                channel_axis=0 if data.ndim == 2 else -2))
        if (name in MULTICHANNEL_FIELDS and data.ndim == 2
                and not self.raw_layout):
            data = np.ascontiguousarray(data.T)   # (C, S) -> (S, C)
        return data

    def __getitem__(self, idx: int) -> Batch:
        if self.cache_size > 0:
            with self._cache_lock:
                if idx in self._cache:
                    return self._cache[idx]
        file_idx, sample_idx = self.index_map[idx]
        f = self._open(file_idx)
        fields = (list(f.keys()) if self.load_fields is None
                  else [k for k in self.load_fields if k in f])
        out = Batch()
        for name in fields:
            data = f[name][sample_idx]
            if name == "guid":
                out[name] = (data.decode() if isinstance(data, bytes)
                             else str(data))
            elif name in ("cs_label", "bg_label"):
                out[name] = bool(data)
            else:
                out[name] = self._process_field(name, np.asarray(data))
        if self.cache_size > 0:
            with self._cache_lock:
                if len(self._cache) >= self.cache_size:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[idx] = out
        return out

    def get_the_lists(self) -> Tuple[List[str], list, list]:
        """GUIDs, epochs and targets of every indexed sample, read in bulk
        per file: the files in the order they first appear in `index_map`,
        each file's samples in index order (the JAX package's
        `get_the_lists`)."""
        guids, epochs, targets = [], [], []
        byfile: Dict[int, List[int]] = {}
        for fi, si in self.index_map:
            byfile.setdefault(fi, []).append(si)
        for fi, sis in byfile.items():
            f = self._open(fi)
            sis = sorted(sis)
            guids.extend(g.decode() if isinstance(g, bytes) else str(g)
                         for g in f["guid"][sis])
            epochs.extend(f["epoch"][sis])
            targets.extend(f["target"][sis])
        return guids, epochs, targets

    def _process_field_batch(self, name: str, data: np.ndarray) -> np.ndarray:
        """`_process_field` over a whole (B, ...) batch the reader owns:
        trim and normalize in place, then one transpose copy."""
        data = self._trim_field(name, data)
        if data.dtype != self.dtype:
            data = data.astype(self.dtype)
        if self._wants_norm(name):
            data = normalize_field_inplace(
                data, name, self.stats[name],
                channel_axis=-2 if data.ndim == 3 else -1)
        if (name in MULTICHANNEL_FIELDS and data.ndim == 3
                and not self.raw_layout):
            return np.ascontiguousarray(np.swapaxes(data, 1, 2))
        return np.ascontiguousarray(data)

    def read_batch(self, indices: Sequence[int]) -> Batch:
        """A whole batch: each row read with one hyperslab selection into a
        preallocated buffer, then trim, normalization and transpose over
        the batch. Equal to `collate(indices)`."""
        from h5py import h5s
        indices = [int(i) for i in indices]
        if self.cache_size > 0:
            with self._cache_lock:
                all_cached = all(i in self._cache for i in indices)
            if all_cached:   # collate takes the lock itself
                return self.collate(indices)
        by_file: Dict[int, List[Tuple[int, int]]] = {}
        for pos, (fi, si) in enumerate(self.index_map[i] for i in indices):
            by_file.setdefault(fi, []).append((pos, si))

        out = Batch()
        n = len(indices)
        raw: Dict[str, np.ndarray] = {}
        rows_written: Dict[str, int] = {}
        guids: Optional[List[Optional[str]]] = None
        for fi, group in by_file.items():
            f = self._open(fi)
            fields = (list(f.keys()) if self.load_fields is None
                      else [k for k in self.load_fields if k in f])
            for name in fields:
                dset = f[name]
                if name == "guid":
                    if guids is None:
                        guids = [None] * n
                    for pos, si in group:
                        g = dset[si]
                        guids[pos] = (g.decode() if isinstance(g, bytes)
                                      else str(g))
                    continue
                row = dset.shape[1:]
                buf = raw.get(name)
                if buf is None:
                    buf = raw[name] = np.empty((n,) + row, dtype=dset.dtype)
                fspace = dset.id.get_space()
                mspace = h5s.create_simple((1,) + row)
                zeros = (0,) * len(row)
                for pos, si in group:
                    fspace.select_hyperslab((si,) + zeros, (1,) + row)
                    dset.id.read(mspace, fspace, buf[pos:pos + 1])
                rows_written[name] = rows_written.get(name, 0) + len(group)

        for name, count in rows_written.items():
            if count != n:   # rows of other files' schemas would be garbage
                raise KeyError(
                    f"field {name!r} present in only {count}/{n} of the "
                    "batch's source files — mixed dataset schemas")

        for name, data in raw.items():
            if name in ("cs_label", "bg_label"):
                out[name] = data.astype(bool)
            else:
                out[name] = self._process_field_batch(name, data)
        if guids is not None:
            out["guid"] = guids

        if self.cache_size > 0:
            with self._cache_lock:
                for k, idx in enumerate(indices):
                    if idx in self._cache:
                        continue
                    if len(self._cache) >= self.cache_size:
                        self._cache.pop(next(iter(self._cache)))
                    # per-sample views into the batch arrays, labels as
                    # Python bools as __getitem__ gives them
                    self._cache[idx] = Batch(
                        {name: (bool(v[k])
                                if name in ("cs_label", "bg_label")
                                else v[k]) for name, v in out.items()})
        return out

    def epoch_indices(self, shuffle: bool, seed: int,
                      shard_index: int = 0, shard_count: int = 1,
                      drop_last: bool = True) -> np.ndarray:
        """One shard's sample order for an epoch: a permutation seeded by
        `seed`, interleaved over shards and cut so that every shard has the
        same count (torch's DistributedSampler with drop_last)."""
        n = len(self)
        order = (np.random.default_rng(seed).permutation(n) if shuffle
                 else np.arange(n))
        if shard_count > 1:
            if drop_last:
                order = order[:(n // shard_count) * shard_count]
            order = order[shard_index::shard_count]
        return order

    def collate(self, indices: Sequence[int]) -> Batch:
        samples = [self[int(i)] for i in indices]
        out = Batch()
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], (np.ndarray, np.generic)):
                out[key] = np.stack(vals)
            elif isinstance(vals[0], bool):
                out[key] = np.asarray(vals)
            else:
                out[key] = vals   # guids stay a list
        return out

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


def prefetch_to_device(iterator: Iterator[Batch], size: int = 2,
                       device=None,
                       array_fields: Optional[Sequence[str]] = None
                       ) -> Iterator[Batch]:
    """Stage host batches onto `device` up to `size` batches ahead.

    A background thread reads the batches and turns each float array (of
    `array_fields`, when given) into a tensor on `device`. For a CUDA
    device the array is copied into pinned memory and from there with
    `non_blocking=True` on a side stream; the consuming stream waits on an
    event recorded after the batch's copies, and each tensor is marked as
    used by that stream, so the allocator does not hand its memory back to
    the side stream while the step still reads it. Other entries pass
    through. Batches keep their order. An exception in the reader reaches
    the consumer, raised from the iteration.
    """
    device = torch.device(device if device is not None else "cpu")
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: Queue = Queue(maxsize=max(1, size))
    stop = threading.Event()

    def put(batch: Batch) -> Tuple[Batch, Optional[torch.cuda.Event]]:
        out = Batch()
        for k, v in batch.items():
            if (isinstance(v, np.ndarray) and v.dtype.kind == "f"
                    and (array_fields is None or k in array_fields)):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    with torch.cuda.device(device), torch.cuda.stream(stream):
                        t = t.pin_memory().to(device, non_blocking=True)
                else:
                    t = t.to(device)
                out[k] = t
            else:
                out[k] = v
        if not cuda:
            return out, None
        event = torch.cuda.Event()
        event.record(stream)
        return out, event

    def worker():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                q.put(("batch", put(batch)))
        except Exception as e:   # handed to the consumer, raised there
            q.put(("error", e))
        else:
            q.put(("end", None))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            kind, item = q.get()
            if kind == "error":
                raise item
            if kind == "end":
                return
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(consumer)
            yield batch
    finally:
        # a consumer that stops early: let the reader finish its batch
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.05)
            except Empty:
                pass
