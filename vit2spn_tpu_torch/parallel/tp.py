"""Tensor parallelism: Megatron-style sharding over the mesh's model group
(port of `vit2spn_tpu/parallel/tp.py`).

The same scheme as the JAX module, which shards by leaf NAME:

  wqkv (.., d, 3d)  column-parallel (last dim)   bqkv, b1: last dim
  w1   (.., d, m)   column-parallel
  wo   (.., d, d)   row-parallel (second-to-last dim)
  w2   (.., m, d)   row-parallel
  heads `linear_0/{w, b}` column-parallel, `linear_{1..}/w` row-parallel
  (the SSP projection and prediction heads, and the classifier head)
  everything else (LayerNorms, embeddings, BN, the row layers' biases)
  whole on every rank.

A leaf whose sharded dim does not divide by the model axis stays whole
(`tp_state_shardings`), as in the JAX module; the rule reads full shapes,
so the parameter tree, the stacked dual-stream trees and Adam's moments all
get it the same way. Each rank then holds its contiguous part of every
sharded leaf (`shard_tree`), and the tensor records the dim it was cut along
in `tp_dim`: `assert_tensor_parallel` counts those, `gather_tree` puts the
whole tree back together for checkpoints and exports.

The JAX package lets GSPMD place the collectives. Here they are the
conjugate autograd pair: `copy_to_model` (identity forward, all-reduce
backward) in front of a column-parallel product and `reduce_from_model`
(all-reduce forward, identity backward) after a row-parallel one, so a block
takes one all-reduce after Wo and one after W2. The stored qkv columns are
q|k|v concatenated, and ViT-Tiny's 3 heads do not split over 2 ranks, so the
rank's qkv columns are gathered back (`gather_columns`, the reshard GSPMD
inserts; its backward is the rank's slice of the summed gradient),
attention runs over all heads, and Wo takes the rank's slice of the
attention output (`my_columns`). Collectives run in fp32 whatever the
compute dtype, so gloo serves bf16 tensors too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from vit2spn_tpu_torch.parallel.mesh import Mesh, all_reduce_fp32

_COL_PARALLEL = {"wqkv", "w1"}  # shard the last (output) dim
_ROW_PARALLEL = {"wo", "w2"}  # shard the second-to-last (input) dim
_COL_BIAS = {"bqkv", "b1"}  # shard the last dim


# ---------------------------------------------------------------------------
# which leaves are sharded
# ---------------------------------------------------------------------------

class P:
    """A PartitionSpec: the mesh axis each dim is split over (None: whole);
    P() is a leaf whole on every rank. Not a tuple, so a tree of specs keeps
    the shape of the tree it describes."""

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __contains__(self, axis) -> bool:
        return axis in self.axes

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and other.axes == self.axes

    def __repr__(self) -> str:
        return f"P{self.axes}"


def divides(n: int, mesh: Optional[Mesh]) -> bool:
    """Whether a dim of n is split over the model axis: TP is on and n
    divides by it (else the leaf stays whole)."""
    return mesh is not None and mesh.model_size > 1 and n % mesh.model_size == 0


def _spec_for(names, leaf, model_axis: str) -> P:
    """The JAX module's rule, by the leaf's name and rank."""
    name = names[-1] if names else ""
    nd = leaf.dim()
    if name in _COL_PARALLEL and nd >= 2:
        return P(*(None,) * (nd - 1), model_axis)
    if name in _ROW_PARALLEL and nd >= 2:
        return P(*(None,) * (nd - 2), model_axis, None)
    if name in _COL_BIAS and nd >= 1:
        return P(*(None,) * (nd - 1), model_axis)
    if len(names) >= 2 and names[-2].startswith("linear_"):
        layer = int(names[-2].split("_")[1])
        if layer == 0 and name in ("w", "b") and nd >= 1:
            return P(*(None,) * (nd - 1), model_axis)
        if layer >= 1 and name == "w" and nd >= 2:
            return P(*(None,) * (nd - 2), model_axis, None)
    return P()


def _map_named(tree, fn, names=()):
    """`fn(names, leaf)` over a tree of dicts, NamedTuples and tuples; the
    names are the dict keys and NamedTuple fields on the way (sequence
    indices are not names, as in the JAX module's `_leaf_names`)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, names + (str(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(getattr(tree, f), fn, names + (f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(v, fn, names) for v in tree)
    return fn(names, tree)


def _leaves(tree) -> list:
    out = []
    _map_named(tree, lambda _, leaf: out.append(leaf))
    return out


def tp_state_shardings(mesh: Mesh, state, model_axis: str = "model"):
    """The spec of every leaf of a WHOLE (unsharded) tree: the model axis at
    its sharded dim, or P() where the leaf stays whole, also where that dim
    does not divide by the axis size. The trainers pass their mesh's axis
    name."""

    def one(names, leaf):
        if not isinstance(leaf, torch.Tensor):
            return P()
        spec = _spec_for(names, leaf, model_axis)
        for dim, ax in enumerate(spec.axes):
            if ax == model_axis and leaf.shape[dim] % mesh.model_size != 0:
                return P()
        return spec

    return _map_named(state, one)


def _annotate(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    if dim is not None:
        t.tp_dim = dim
    return t


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's part of every sharded leaf of a whole tree (a copy with
    its own storage, `tp_dim` set); other leaves as they are."""
    spec_leaves = iter(_leaves(specs))

    def one(_, leaf):
        spec = next(spec_leaves)
        if mesh.model_axis not in spec:
            return leaf
        dim = spec.axes.index(mesh.model_axis)
        return _annotate(_my_part(leaf, dim, mesh).clone(memory_format=torch.contiguous_format),
                         dim)

    return _map_named(tree, one)


def shard_like(tree, like, mesh: Mesh):
    """This rank's part of a whole tree, cut where `like`'s leaves record a
    `tp_dim` (a restored checkpoint, cut as the live state is)."""
    like_leaves = iter(_leaves(like))

    def one(_, leaf):
        dim = getattr(next(like_leaves), "tp_dim", None)
        return leaf if dim is None else _my_part(leaf, dim, mesh).contiguous()

    return _map_named(tree, one)


def gather_tree(tree, mesh: Mesh):
    """The whole tree back from every rank's parts (a collective over the
    model group: every rank calls it). Leaves without `tp_dim` as they are."""
    def one(_, leaf):
        dim = getattr(leaf, "tp_dim", None)
        if dim is None:
            return leaf
        return _all_gather(leaf.detach(), dim, mesh)

    return _map_named(tree, one)


def assert_tensor_parallel(state, model_axis: str = "model") -> int:
    """The number of leaves (parameters and Adam moments) that hold a shard;
    raises if none does: the check that keeps the TP claim honest."""
    count = sum(1 for leaf in _leaves(state) if getattr(leaf, "tp_dim", None) is not None)
    if count == 0:
        raise AssertionError(f"no leaf is partitioned over {model_axis!r}")
    return count


def annotate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` (an optimizer moment) records the shard dim of `like` (its param)."""
    return _annotate(t, getattr(like, "tp_dim", None))


# ---------------------------------------------------------------------------
# collectives, with their gradients
# ---------------------------------------------------------------------------

def _my_part(t, dim: int, mesh: Mesh):
    k = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model * k, k)


def _all_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    y = x.detach().to(torch.float32).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.model_size)]
    dist.all_gather(parts, y, group=mesh.model_group)
    return torch.cat(parts, dim=dim).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_fp32(g, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_fp32(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, x.dim() - 1, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return _my_part(all_reduce_fp32(g, mesh.model_group), g.dim() - 1, mesh).contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; the backward sums the ranks' partial gradients."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of the ranks' partial products; the backward is the identity."""
    return _ReduceFromModel.apply(x, mesh)


def gather_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's columns (last dim) in rank order."""
    return _GatherColumns.apply(x, mesh)


def my_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous part of the last dim."""
    return _my_part(x, x.dim() - 1, mesh)


def column_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x (whole on every rank) @ this rank's columns of W, + its part of b."""
    return copy_to_model(x, mesh) @ w + b


def row_linear(x: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's columns of x @ its rows of W, summed over the ranks (the
    bias, whole, is the caller's to add after)."""
    return reduce_from_model(x @ w, mesh)
