"""Data- and tensor-parallel training on a mesh of ranks.

The JAX package gets these from GSPMD when its jitted step consumes a
sharded batch (`vae_teb_tpu.train.trainer`); here they are explicit, and
`Trainer` and `ClassifierTrainer` share them through `MeshRunner`:

- the ranks start from rank 0's parameters and buffers (one broadcast);
- BatchNorm's training statistics reduce over the data group
  (`sync_batch_norm`);
- the noise is the global batch's, each rank keeping its rows
  (`MeshRunner.noise`);
- gradients are averaged over the data group before the optimizer, in one
  flat all_reduce (every loss term is a batch mean and ranks hold equal
  rows, so this is the global batch's gradient), and so are the metrics,
  so that history, log lines and early stopping agree on every rank;
- the replicated parameters' gradients are averaged over the model group
  too: its ranks compute them from the same rows, but on the card some
  backward kernels add with atomics in a varying order, so without it the
  model ranks' copies would drift apart by rounding;
- on a 'model' axis of size > 1 the wide `Dense` weights keep the rank's
  rows (`shard_dense`, the JAX package's `tensor_parallel_rule`), and with
  them their Adam moments; `full_state` / `local_state` convert a
  trainer's state between that layout and full arrays, so a checkpoint
  holds global arrays, as Orbax's do, and loads under any layout.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.blocks import BatchNorm, Dense
from ..parallel.collectives import all_reduce_mean_, gather_rows, noise_rows
from ..parallel.mesh import Mesh, Sharded, tensor_parallel_rule


def sync_batch_norm(model: nn.Module, group, size: int) -> int:
    """Reduce every BatchNorm's training statistics over `group` (`size`
    ranks); returns the number of BatchNorm layers."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group, m.group_size = group, size
            n += 1
    return n


def shard_dense(model: nn.Module, mesh: Mesh, min_dim: int
                ) -> Dict[str, Sharded]:
    """Keep this rank's rows of every `nn.Linear` weight that
    `tensor_parallel_rule(mesh, min_dim)` shards, and make its `Dense`
    column-parallel over the mesh's model group. Returns {state_dict key:
    sharding} of the sharded weights."""
    rule = tensor_parallel_rule(mesh, min_dim)
    out = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        sh = rule(mod.weight)
        if not isinstance(sh, Sharded):
            continue
        if not isinstance(mod, Dense):
            raise TypeError(f"{name} is an nn.Linear without a column-"
                            "parallel forward; only Dense shards")
        mod.weight = nn.Parameter(sh(mod.weight.detach()).clone())
        mod.tensor_parallel = (mesh.group("model"), sh.index, sh.count)
        out[f"{name}.weight" if name else "weight"] = sh
    return out


@torch.no_grad()
def _broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src)
        parts = torch.split(flat, [t.numel() for t in ts])
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(parts, ts)])


def _map_optimizer_state(state: Mapping, index: Dict[int, Sharded], fn):
    """fn(tensor, sharding) on the entries of a ClippedAdamW (or MultiSteps
    around one) state_dict that belong to sharded parameters (by position
    in the parameter list)."""
    out = dict(state)
    if "inner" in state:     # MultiSteps
        out["inner"] = _map_optimizer_state(state["inner"], index, fn)
        if state["acc"] is not None:
            out["acc"] = [fn(a, index[i]) if i in index else a
                          for i, a in enumerate(state["acc"])]
        return out
    for k in ("mu", "nu"):
        out[k] = [fn(t, index[i]) if i in index and t is not None else t
                  for i, t in enumerate(state[k])]
    return out


class MeshRunner:
    """A trainer's view of its mesh: its data and model groups, this rank's
    place, the sharded weights, and the collectives of a step."""

    def __init__(self, mesh: Mesh, model: nn.Module, tp_min_dim=None):
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.data_group = mesh.group("data")
        self.n_data = mesh.axis_size("data")
        self.data_index = mesh.coords.get("data", 0)
        self.model_group = mesh.group("model")
        self.n_model = mesh.axis_size("model")
        _broadcast_(list(model.parameters()) + list(model.buffers()))
        sync_batch_norm(model, self.data_group, self.n_data)
        self.sharded: Dict[str, Sharded] = (
            shard_dense(model, mesh, tp_min_dim)
            if tp_min_dim is not None and self.n_model > 1 else {})
        names = [n for n, _ in model.named_parameters()]
        self._param_index = {names.index(n): sh
                             for n, sh in self.sharded.items()}
        self.sharded_params: List[nn.Parameter] = [
            model.get_parameter(n) for n in self.sharded]

    def noise(self):
        """The context of a forward: noise draws keep the rank's rows of
        the global batch's."""
        return noise_rows(self.data_index, self.n_data)

    def reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Average the parameters' gradients over the data group, and the
        replicated ones' over the model group."""
        all_reduce_mean_([p.grad for p in params if p.grad is not None],
                         self.data_group, self.n_data)
        if self.n_model > 1:
            sharded = {id(p) for p in self.sharded_params}
            all_reduce_mean_([p.grad for p in params if p.grad is not None
                              and id(p) not in sharded],
                             self.model_group, self.n_model)

    @torch.no_grad()
    def mean(self, metrics: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Each 0-dim metric averaged over the data group (one all_reduce)."""
        keys = list(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(vals, group=self.data_group)
        vals /= self.n_data
        return dict(zip(keys, vals.unbind(0)))

    def _gather(self, t: torch.Tensor, sh: Sharded) -> torch.Tensor:
        return gather_rows(t, self.model_group, sh.count)

    def full_state(self, model_state: Mapping, optimizer_state: Mapping):
        """(model state_dict, optimizer state_dict) with every sharded
        weight, moment and accumulated gradient gathered whole; a
        collective: every rank calls it."""
        model_state = dict(model_state)
        for k, sh in self.sharded.items():
            model_state[k] = self._gather(model_state[k], sh)
        return model_state, _map_optimizer_state(
            optimizer_state, self._param_index, self._gather)

    def local_state(self, model_state: Mapping, optimizer_state: Mapping):
        """The inverse of `full_state`: full arrays cut to this rank's
        rows."""
        model_state = dict(model_state)
        for k, sh in self.sharded.items():
            model_state[k] = sh(model_state[k])
        return model_state, _map_optimizer_state(
            optimizer_state, self._param_index, lambda t, sh: sh(t))
