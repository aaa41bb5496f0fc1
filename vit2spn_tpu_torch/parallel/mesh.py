"""Process mesh and batch slicing (port of `vit2spn_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a (data, model) `jax.sharding.Mesh`
and lets XLA insert the collectives. Here every rank is one process with one
device, and the mesh is that rank's place in the same layout: world size
`n` reshaped to (n // model_parallel, model_parallel), so rank r sits at
data coordinate r // model_parallel and model coordinate r % model_parallel,
as `np.reshape` orders the JAX devices. The two process groups are the ranks
that share a model coordinate (`data_group`: the data-parallel reduction)
and the ranks that share a data coordinate (`model_group`: the tensor-
parallel collectives, parallel/tp.py).

Without an initialized process group the mesh is world size 1 and holds no
group: nothing calls a collective. Under `torchrun` (or the spawned ranks of
parallel/launch.py) `init_distributed` starts the group first; then even a
world of 1 runs its collectives, which are the identity there.

`batch_sharding`, `replicated_sharding` and `shard_batch` keep the JAX names
for what they mean here: which part of a batch dimension this rank holds.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vit2spn_tpu_torch.core.runtime import resolve_device

# how long a collective may wait for the other ranks before it raises: a
# rank that dies or hangs fails the run instead of stalling it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) layout and its groups.

    `data_group` / `model_group` are None where no collective is needed:
    outside an initialized process group, and for a model axis of size 1."""

    world_size: int = 1
    rank: int = 0
    model_size: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    data_group: Any = None
    model_group: Any = None
    device: Optional[torch.device] = None

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def data(self) -> int:
        """This rank's data coordinate (its slice of every batch)."""
        return self.rank // self.model_size

    @property
    def model(self) -> int:
        """This rank's model coordinate (its shard of the TP leaves)."""
        return self.rank % self.model_size

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (self.data_axis, self.model_axis)

    @property
    def shape(self) -> dict:
        return {self.data_axis: self.data_size, self.model_axis: self.model_size}

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def data_slice(self, n: int) -> slice:
        """This rank's contiguous part of a batch dimension of n."""
        if n % self.data_size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.data_size} data ranks")
        k = n // self.data_size
        return slice(self.data * k, (self.data + 1) * k)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def current_rank() -> int:
    """This process's rank in the initialized process group, else 0."""
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, reduced in fp32 (gloo takes no bf16) into
    a new tensor of x's dtype; `x` is left as it was."""
    y = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: str = "env://", rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start this process's rank and return its device.

    Rank and world size come from torchrun's RANK / WORLD_SIZE unless given.
    On `cuda` (the default) a device without an index becomes
    `cuda:LOCAL_RANK` and the backend NCCL; `backend="gloo"` serves CUDA
    tensors too, for ranks that share one card, and is used only when asked
    for. A failed init raises: no run carries on as one process."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=COLLECTIVE_TIMEOUT)
    return dev


def make_mesh(model_parallel: int = 1, data_axis: str = "data",
              model_axis: str = "model", backend: Optional[str] = None,
              device=None) -> Mesh:
    """This rank's (data, model) mesh over the initialized process group, or
    world size 1 without one. `backend` names the subgroups' backend (the
    default group's when None); `device`, the rank's device, is recorded."""
    device = None if device is None else torch.device(device)
    if not dist.is_initialized():
        n, rank = 1, 0
    else:
        n, rank = dist.get_world_size(), dist.get_rank()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        return Mesh(1, 0, model_parallel, data_axis, model_axis, device=device)
    tp, dp = model_parallel, n // model_parallel
    layout = np.arange(n).reshape(dp, tp)
    # every rank creates every group, in the same order (torch.distributed's
    # rule); a group that spans the world is the default group
    data_group = model_group = None
    for m in range(tp):
        ranks = layout[:, m].tolist()
        g = dist.group.WORLD if dp == n else dist.new_group(ranks, backend=backend)
        if rank in ranks:
            data_group = g
    if tp > 1:
        for d in range(dp):
            ranks = layout[d].tolist()
            g = dist.group.WORLD if tp == n else dist.new_group(ranks, backend=backend)
            if rank in ranks:
                model_group = g
    return Mesh(n, rank, tp, data_axis, model_axis, data_group, model_group, device)


@dataclass(frozen=True)
class Sharding:
    """Which dims of an array this rank holds a part of: `spec` names the
    mesh axis per dim (None: whole), as a JAX PartitionSpec does."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def shard(self, x):
        """This rank's part of `x` (a tensor or numpy array)."""
        idx = []
        for dim, ax in enumerate(self.spec):
            if ax == self.mesh.data_axis:
                idx.append(self.mesh.data_slice(x.shape[dim]))
            elif ax is None:
                idx.append(slice(None))
            else:
                raise ValueError(f"batch sharding over {ax!r} is not supported")
        return x[tuple(idx)]


def batch_sharding(mesh: Mesh, ndim: int, data_axis: str = "data") -> Sharding:
    """Split dim 0 (batch) over the data axis, keep the rest whole."""
    return Sharding(mesh, (data_axis,) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, batch, data_axis: str = "data"):
    """This rank's part of a host or device batch (a dict, tuple or list of
    arrays, or one array) along dim 0."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, data_axis) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, data_axis) for v in batch)
    return batch_sharding(mesh, batch.ndim, data_axis).shard(batch)
