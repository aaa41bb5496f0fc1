"""Data parallelism with one explicit reduction (port of
`vit2spn_tpu/parallel/shard_map_dp.py`).

The JAX module wraps a per-shard step in `jax.shard_map` and reduces its
gradients with `psum` / `pmean` over the mesh's data axis. Here each rank is
a process: `shard_map_dp_step` gives the local step this rank's slice of the
batch and a random key that carries the data rank, then reduces the step's
gradients and metrics over the data group in ONE all-reduce of a flattened
fp32 buffer (`all_reduce_grads`), unflattened in place. Only `all_reduce`
and `broadcast` are used, so gloo serves CUDA tensors too (it has no
`reduce_scatter`). DistributedDataParallel is not used: the trainers are
functional, and DDP averages, which is wrong for the masked tail.

Two reduction contracts, as in the JAX module (`grad_reduce`):

  * "pmean": the local step returns local-batch means; the wrapper averages
    them over the ranks. Right only for uniform per-sample weights.
  * "psum": the local step returns partial sums already normalized by the
    GLOBAL weight sum; the wrapper adds them. The SSP trainer's weight-masked
    tail (ssp_vit2spn_tiny.py:215) is exact this way however unevenly its
    real samples fall across the ranks.

Metrics reduce as the gradients do: under "psum" a local step returns its
partial sums, under "pmean" its local means.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from vit2spn_tpu_torch.parallel.mesh import Mesh, all_reduce_fp32

GRAD_REDUCES = ("pmean", "psum")


def _check(grad_reduce: str) -> None:
    if grad_reduce not in GRAD_REDUCES:
        raise ValueError(f"grad_reduce must be 'pmean' or 'psum', got {grad_reduce!r}")


def all_reduce_grads(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     grad_reduce: str = "psum") -> None:
    """Sum (or average) `tensors` over the mesh's data group, in place, in
    one all-reduce of their flattened fp32 copy. Outside an initialized
    process group this does nothing; in a world of 1 the all-reduce runs and
    is the identity."""
    _check(grad_reduce)
    if mesh.data_group is None:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    if grad_reduce == "pmean":
        flat /= mesh.data_size
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite `tensors` with data rank 0's values, in place, in one
    broadcast over the data group (parameters and optimizer state after an
    init or a restore). Nothing to do on one data rank."""
    if mesh.data_group is None or mesh.data_size == 1:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    # the data group's rank 0 holds this rank's model coordinate
    dist.broadcast(flat, src=mesh.model, group=mesh.data_group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_gather_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(data ranks, *x.shape): every data rank's `x` in rank order, gathered
    in fp32 and returned in x's dtype; x[None] outside a process group."""
    if mesh.data_group is None:
        return x[None]
    y = x.detach().to(torch.float32).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.data_size)]
    dist.all_gather(parts, y, group=mesh.data_group)
    return torch.stack(parts).to(x.dtype)


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_fp32(x, mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_fp32(g, ctx.mesh.data_group), None


def sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the data ranks, with its gradient: each rank's
    loss is a partial sum of the global one, so the gradient of the sum is
    the sum of the ranks' gradients (an all-reduce both ways, the
    SyncBatchNorm statistics' rule)."""
    return _SumOverData.apply(x, mesh)


def fold_rank(key: Sequence[int], mesh: Mesh) -> tuple:
    """The random-stream key of this rank's slice: the data rank is one more
    key (the JAX wrapper's fold_in of axis_index), so the ranks draw other
    augmentation and dropout bits. With one data rank the key is unchanged,
    so world size 1 under a process group draws the bits of a plain run."""
    return tuple(key) + ((mesh.data,) if mesh.data_size > 1 else ())


def shard_map_dp_step(
    local_step: Callable,
    mesh: Mesh,
    data_axis: str = "data",
    grad_reduce: str = "pmean",
    batch_dim: int = 0,
):
    """Wrap a per-rank step into a data-parallel step with one reduction.

    `local_step(state, local_batch, key, local_w) -> (grads, metrics)`:
    `grads` a list of tensors (reduced in place), `metrics` a dict of
    tensors. The wrapper slices `batch` and `w` along `batch_dim` for this
    rank (the SSP trainer passes (accum, B, ...) microbatches with
    batch_dim=1, so every rank holds a slice of EVERY microbatch, as the JAX
    trainer shards axis 1), folds the data rank into `key`, and reduces the
    gradients and the metrics in one all-reduce under `grad_reduce`."""
    _check(grad_reduce)
    if data_axis != mesh.data_axis:
        raise ValueError(f"the mesh's data axis is {mesh.data_axis!r}, not {data_axis!r}")

    def step(state, batch, key, w):
        sl = (slice(None),) * batch_dim + (mesh.data_slice(batch.shape[batch_dim]),)
        grads, metrics = local_step(state, batch[sl], fold_rank(key, mesh), w[sl])
        names = sorted(metrics)
        all_reduce_grads(list(grads) + [metrics[k] for k in names], mesh, grad_reduce)
        return grads, metrics

    return step

