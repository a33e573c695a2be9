"""Process groups and the sharding policy of multi-device training.

Port of `vae_teb_tpu.parallel.mesh` on `torch.distributed`. The JAX
package lays one program over a device mesh and lets GSPMD place the
collectives; here every device is a process (torchrun's ranks), and a mesh
is the rank's place in a grid of ranks with one process group per axis:

  data_parallel_mesh()    ("data",): every rank a data-parallel replica
  hybrid_mesh(nd, nm)     ("data", "model"): rank = d * nm + m, so the
                          ranks of a model group are adjacent (one node's
                          NVLink, as JAX lays 'model' on ICI)

Shardings are callables that give a rank its part of a global array:
`batch_sharding` its rows of a batch, `stacked_batch_sharding` its rows
of axis 1 of a (K, B, ...) stack, `replicated_sharding` everything, and
`tensor_parallel_rule` its rows of the wide `nn.Linear` weights (a flax
kernel's output columns).

The collectives the training path calls are all_reduce, broadcast and
all_gather, the ones both NCCL and gloo take on CUDA tensors, so ranks
that share one card over gloo run the production code.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Distributed(NamedTuple):
    """What `init_distributed` set up: this process's rank, the world size,
    torchrun's LOCAL_RANK and the device the rank computes on."""
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


_device: Optional[torch.device] = None   # the rank's device, once initialized


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = 600.0) -> Distributed:
    """Join the process group torchrun describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

    The rank computes on `device`, by default the card `cuda:LOCAL_RANK`
    (raising without one; pass device="cpu" for CPU ranks). The backend
    defaults to NCCL on a CUDA device and gloo on the CPU; asking for NCCL
    without a card raises. gloo on CUDA tensors lets ranks share one card,
    which NCCL refuses. A second call returns the group already joined.
    """
    global _device
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass device='cpu' "
                               "to run the ranks on the CPU")
        device = f"cuda:{local_rank}"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and (device.type != "cuda"
                              or not torch.cuda.is_available()):
        raise RuntimeError("the NCCL backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            if key not in os.environ:
                raise RuntimeError(f"{key} is not set: launch the ranks with "
                                   "torchrun, or set the environment")
        dist.init_process_group(
            backend=backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=device if backend == "nccl" else None)
    _device = device
    return Distributed(dist.get_rank(), dist.get_world_size(), local_rank,
                       device)


def _rank_device() -> torch.device:
    """The device `init_distributed` gave this rank."""
    if _device is None:
        raise RuntimeError("call init_distributed() first")
    return _device


class Mesh:
    """A rank's place in a grid of ranks: `axis_names`, `shape` (axis ->
    size, as a JAX Mesh's), `coords` (axis -> this rank's index along it),
    `groups` (axis -> the process group of the ranks that differ from this
    one along that axis only), and the rank's `device`."""

    def __init__(self, axis_names: Sequence[str], shape: Dict[str, int],
                 coords: Dict[str, int],
                 groups: Optional[Dict[str, Optional[dist.ProcessGroup]]]
                 = None, device=None):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.coords = {a: int(coords[a]) for a in self.axis_names}
        self.groups = dict(groups or {})
        self.device = torch.device(device) if device is not None else None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        """The size of `axis`, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, coords={self.coords}, "
                f"device={self.device})")


def _world() -> Tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    return dist.get_rank(), dist.get_world_size()


def data_parallel_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The ("data",) mesh over every rank of the world (n_devices, when
    given, must be the world size: a rank is a device)."""
    rank, world = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a data-parallel mesh of {n_devices} devices needs "
                         f"{n_devices} ranks, the world has {world}")
    return Mesh(("data",), {"data": world}, {"data": rank},
                {"data": dist.group.WORLD}, _rank_device())


def hybrid_mesh(n_data: int, n_model: int) -> Mesh:
    """The ("data", "model") mesh: data parallelism on the first axis,
    tensor parallelism of the wide decoder heads on the second. Rank
    r = d * n_model + m; raises unless n_data * n_model is the world size.
    Every rank creates every group, in one order, as torch.distributed
    requires."""
    rank, world = _world()
    if n_data * n_model != world:
        raise ValueError(f"need {n_data * n_model} devices, have {world}")
    grid = np.arange(world).reshape(n_data, n_model)
    d, m = divmod(rank, n_model)
    groups = {}
    for m_ in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m_]])
        if m_ == m:
            groups["data"] = g
    for d_ in range(n_data):
        g = dist.new_group([int(r) for r in grid[d_]])
        if d_ == d:
            groups["model"] = g
    return Mesh(("data", "model"), {"data": n_data, "model": n_model},
                {"data": d, "model": m}, groups, _rank_device())


class Replicated:
    """Every rank holds the whole array."""

    def __call__(self, x):
        return x

    def __repr__(self) -> str:
        return "Replicated()"


class Sharded:
    """Rank `index` of `count` holds block `index` of `axis` (equal
    blocks: the axis must divide)."""

    def __init__(self, axis: int, index: int, count: int):
        self.axis, self.index, self.count = axis, index, count

    def block(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"axis of {n} does not split over {self.count} "
                             "ranks")
        b = n // self.count
        return slice(self.index * b, (self.index + 1) * b)

    def __call__(self, x):
        idx = (slice(None),) * self.axis + (self.block(x.shape[self.axis]),)
        return x[idx]

    def __repr__(self) -> str:
        return f"Sharded(axis={self.axis}, {self.index} of {self.count})"


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharded:
    """The rank's rows (axis 0) of a global batch."""
    return Sharded(0, mesh.coords.get(axis_name, 0),
                   mesh.axis_size(axis_name))


def stacked_batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharded:
    """The rank's rows of a (K, B, ...) stack of K batches: axis 1, as one
    batch's axis 0."""
    return Sharded(1, mesh.coords.get(axis_name, 0),
                   mesh.axis_size(axis_name))


def replicated_sharding(mesh: Mesh) -> Replicated:
    """Parameters, optimizer state and scalars: the whole array."""
    return Replicated()


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """The rank's rows of every numeric array or tensor of a global batch;
    other entries (guids, labels as lists) pass through."""
    sh = batch_sharding(mesh, axis_name)
    out = {}
    for k, v in batch.items():
        numeric = (isinstance(v, torch.Tensor)
                   or (isinstance(v, np.ndarray) and v.dtype.kind in "fiub"))
        out[k] = sh(v) if numeric else v
    return type(batch)(out) if not isinstance(batch, dict) else out


def tensor_parallel_rule(mesh: Mesh, min_dim: int = 2048):
    """The JAX package's shape rule for a hybrid mesh, on torch layouts:
    rule(weight) shards a 2-D `nn.Linear` weight (out, in) whose output dim
    is >= min_dim and divisible by the 'model' axis over its rows, each
    model rank keeping out / n_model of them (flax's (in, out) kernel
    sharded P(None, 'model')); anything else, 1-D leaves and biases
    included, is replicated. The same rule places the Adam moments, so a
    sharded weight's moments live sharded too.

    The port applies it to `nn.Linear` weights only. JAX's rule would also
    shard other 2-D leaves whose last dim reaches a lowered min_dim (the
    LSTM kernels, for instance), a layout choice with no effect on the
    numbers under GSPMD; the port keeps those replicated. At the
    production min_dim=2048 both rules select exactly the four 4800x4800
    decoder-head kernels."""
    m = mesh.axis_size("model")
    shard = Sharded(0, mesh.coords.get("model", 0), m)
    repl = Replicated()

    def rule(x):
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) == 2 and shape[0] >= min_dim and shape[0] % m == 0:
            return shard
        return repl
    return rule
