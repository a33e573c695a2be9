"""Checkpoints with best-k-on-metric retention.

Port of `vae_teb_tpu.train.checkpoint.Checkpointer` on `torch.save`: the
same `index.json` ({step, metric, path} entries), the same retention (the
best `keep` by metric, lower is better, plus always the latest) and the
same `best()`, `latest()` and `restore(step=, best=)`; rank 0 of a
distributed run writes, every rank reads. A checkpoint is a
directory `step_<step:08d>/` holding `state.pt`, the trainer's
`state_dict()` (model parameters and BatchNorm statistics, optimizer
moments in their storage dtype with the update count, generator state,
step count). `transfer_params` copies matching entries between models'
state_dicts (loading a pretrained VAE into the classifier wrapper).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

_STATE = "state.pt"


class Checkpointer:
    """Save and restore trainer states, keeping the best `keep` by metric
    plus the latest."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._index_path = os.path.join(self.directory, "index.json")
        self._index: List[Dict] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, state: Mapping, step: int,
             metric: Optional[float] = None) -> None:
        """Write `state` (a trainer's state_dict()) as checkpoint `step`,
        then drop what the retention rule no longer keeps. The state file
        is written whole before it replaces an older one of the step. In a
        torch.distributed run only rank 0 writes (every rank holds the same
        state and shares the directory); the other ranks' calls do nothing
        and `restore` reads rank 0's files on every rank."""
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        path = self._path(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _STATE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, _STATE))
        self._index = [e for e in self._index if e["path"] != path]
        self._index.append({"step": step, "metric": metric, "path": path})
        self._gc()
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=2)

    def _gc(self) -> None:
        if len(self._index) <= self.keep + 1:
            return
        latest = max(self._index, key=lambda e: e["step"])
        scored = [e for e in self._index if e["metric"] is not None]
        best = sorted(scored, key=lambda e: e["metric"])[:self.keep]
        keep_paths = {latest["path"]} | {e["path"] for e in best}
        for entry in list(self._index):
            if entry["path"] not in keep_paths:
                self._index.remove(entry)
                shutil.rmtree(entry["path"], ignore_errors=True)

    def best(self) -> Optional[Dict]:
        scored = [e for e in self._index if e["metric"] is not None]
        return min(scored, key=lambda e: e["metric"]) if scored else None

    def latest(self) -> Optional[Dict]:
        return max(self._index, key=lambda e: e["step"]) if self._index else None

    def restore(self, step: Optional[int] = None, best: bool = False,
                map_location="cpu") -> Dict:
        """The saved state of checkpoint `step`, the best one (best=True) or
        the latest, for `Trainer.load_state_dict`; tensors on
        `map_location`."""
        if best:
            entry = self.best()
        elif step is not None:
            entry = next((e for e in self._index if e["step"] == step), None)
        else:
            entry = self.latest()
        if entry is None:
            raise FileNotFoundError("no checkpoint matches the request")
        return torch.load(os.path.join(entry["path"], _STATE),
                          map_location=map_location, weights_only=True)


def transfer_params(src: Mapping[str, torch.Tensor],
                    dst: Mapping[str, torch.Tensor],
                    src_prefix: Tuple[str, ...] = (),
                    dst_prefix: Tuple[str, ...] = (),
                    strict: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Copy matching entries between state_dicts (checkpoint surgery), as
    the JAX package's `transfer_params` does between flax trees.

    A key of `dst` under `dst_prefix` (key segments split at ".") takes the
    entry of `src` at `src_prefix` + the rest of the key, when `src` has
    one of the same shape; e.g. a pretrained VAE into the classifier:
        transfer_params(vae.state_dict(), cls.state_dict(),
                        dst_prefix=("vae_model",))
    A missing source entry or a shape mismatch leaves the entry as it was,
    or raises with strict (KeyError, ValueError). Returns (the new
    state_dict, the copied keys of dst); `dst` itself is not changed.
    """
    out: Dict[str, torch.Tensor] = dict(dst)
    copied: List[str] = []
    n = len(dst_prefix)
    for key, leaf in dst.items():
        parts = tuple(key.split("."))
        if parts[:n] != tuple(dst_prefix):
            continue
        lookup = ".".join(tuple(src_prefix) + parts[n:])
        if lookup not in src:
            if strict:
                raise KeyError(f"missing source entry for {key}")
            continue
        if tuple(src[lookup].shape) != tuple(leaf.shape):
            if strict:
                raise ValueError(f"shape mismatch at {key}")
            continue
        out[key] = src[lookup]
        copied.append(key)
    return out, copied
