"""Projection / prediction / classifier heads (port of
`vit2spn_tpu/models/heads.py`).

  * projection_head: Linear(384->1024) ReLU Dropout(.3) Linear(1024->128)
    (ssp_vit2spn_tiny.py:133-138; single-stream input 192).
  * prediction_head: Linear(128->128) ReLU Linear(128->128)
    (ssp_vit2spn_tiny.py:139-143).
  * fine-tune fc: Linear(192->128) BatchNorm1d ReLU Dropout(.5)
    Linear(128->classes) (octmnist_ft_vit2spn.py:77-83).

Params are dicts `linear_<i>/{w (in, out), b}` (and the classifier's
`bn/{scale, bias}`) in the JAX layout. Initialization follows torch.nn.Linear
defaults (U(+-1/sqrt(fan_in)) for weights and biases). The heads' GEMMs are
plain products outside any Pallas kernel in the JAX package too.

Under a `mesh` (parallel/mesh.py) the heads run their part of a multi-rank
step: a weight that holds a tensor-parallel shard (its `tp_dim`, set by
parallel/tp.py) multiplies column- or row-parallel, dropout draws the whole
mask and keeps this rank's columns, and the classifier's train-mode
BatchNorm takes its batch statistics over every data rank (the
SyncBatchNorm semantics the JAX package gets from GSPMD).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vit2spn_tpu_torch.parallel import tp
from vit2spn_tpu_torch.parallel.shard_map_dp import sum_over_data


def _torch_linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> dict:
    bound = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim)).uniform_(-bound, bound, generator=gen)
    b = torch.empty((out_dim,)).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def init_mlp_head(gen: torch.Generator, dims: Tuple[int, ...]) -> dict:
    """Stack of Linear layers with ReLU in between (CPU tensors; the caller
    moves them)."""
    return {
        f"linear_{i}": _torch_linear_init(gen, dims[i], dims[i + 1])
        for i in range(len(dims) - 1)
    }


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             mesh=None):
    """Inverted dropout with a mask drawn from `generator`, which must live on
    x's device (a CUDA generator for CUDA tensors). With `mesh`, x is this
    rank's columns of a tensor-parallel activation: the whole mask is drawn
    and the rank keeps its columns, so the draw equals one rank's."""
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    gd = generator.device
    if gd.type != x.device.type or gd.index not in (None, x.device.index):
        raise ValueError(f"the dropout generator is on {gd}, x on {x.device}")
    keep = 1.0 - rate
    shape = x.shape if mesh is None else (*x.shape[:-1], x.shape[-1] * mesh.model_size)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if mesh is not None:
        mask = tp.my_columns(mask, mesh)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def _linear(p: dict, x: torch.Tensor, mesh):
    """x @ w + b in x's dtype; column-parallel (x whole, the output this
    rank's columns) or row-parallel (x this rank's columns, the output
    summed over the ranks) where w holds a tensor-parallel shard. Returns
    (out, whether out is a column shard)."""
    w, b = p["w"].to(x.dtype), p["b"].to(x.dtype)
    dim = None if mesh is None or mesh.model_size == 1 else getattr(p["w"], "tp_dim", None)
    if dim is None:
        return x @ w + b, False
    if dim == w.dim() - 1:
        return tp.column_linear(x, w, b, mesh), True
    return tp.row_linear(x, w, mesh) + b, False


def mlp_head_apply(
    params: dict,
    x: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    dropout_after_layer: int = -1,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Linear -> ReLU [-> Dropout] -> ... -> Linear (no activation on last).
    Dropout is active only with `train=True` and draws its mask from the
    explicit `generator`, which lives on x's device (a CUDA generator for
    CUDA tensors). `mesh`: the tensor-parallel products where the weights
    hold shards."""
    n = len(params)
    for i in range(n):
        x, sharded = _linear(params[f"linear_{i}"], x, mesh)
        if i < n - 1:
            x = torch.relu(x)
            if train and dropout_rate > 0.0 and i == dropout_after_layer:
                x = _dropout(x, dropout_rate, generator, mesh if sharded else None)
    return x


def init_classifier_head(gen: torch.Generator, in_dim: int, hidden: int,
                         num_classes: int) -> dict:
    """FineTunedModel.fc (octmnist_ft_vit2spn.py:77-83): Linear, BN affine
    params, Linear (CPU tensors; the caller moves them)."""
    return {
        "linear_0": _torch_linear_init(gen, in_dim, hidden),
        "bn": {"scale": torch.ones((hidden,)), "bias": torch.zeros((hidden,))},
        "linear_1": _torch_linear_init(gen, hidden, num_classes),
    }


def init_bn_state(hidden: int, device=None) -> dict:
    """BatchNorm1d running statistics; `count` (int32) counts train-mode
    updates."""
    return {
        "mean": torch.zeros((hidden,), device=device),
        "var": torch.ones((hidden,), device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def classifier_head_apply(
    params: dict,
    bn_state: dict,
    x: torch.Tensor,
    *,
    dropout_rate: float = 0.5,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    bn_momentum: float = 0.1,
    bn_eps: float = 1e-5,
    mesh=None,
) -> Tuple[torch.Tensor, dict]:
    """Linear -> BatchNorm1d -> ReLU -> Dropout -> Linear, at the JAX
    function's rounding points: the linears in x's dtype, BN in fp32 on the
    rounded linear output and cast back before ReLU, fp32 logits.

    Returns (logits, new_bn_state). Train mode normalizes with the batch
    statistics (biased variance) and updates the running ones with torch's
    unbiased-variance convention at `bn_momentum` (the new state carries no
    autograd graph); eval mode uses the running statistics and returns
    `bn_state` itself.

    Under a `mesh` with more than one data rank, x is this rank's slice of
    the batch and train mode's statistics are the global batch's: the sum
    for the mean, then the sum of centred squares for the variance, each
    over the data ranks with its gradient; the running update counts the
    global n. Where linear_0 holds a tensor-parallel shard, BN (per feature)
    normalizes this rank's features and the running statistics are gathered
    whole."""
    x, sharded = _linear(params["linear_0"], x, mesh)

    x32 = x.float()
    if train:
        if mesh is not None and mesh.data_size > 1:
            n = x32.shape[0] * mesh.data_size
            mean = sum_over_data(torch.sum(x32, dim=0), mesh) / n
            var = sum_over_data(torch.sum((x32 - mean) ** 2, dim=0), mesh) / n
        else:
            n = x32.shape[0]
            mean = torch.mean(x32, dim=0)
            var = torch.var(x32, dim=0, unbiased=False)  # used for normalization
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            run_mean, run_var = ((tp.gather_columns(mean, mesh), tp.gather_columns(unbiased, mesh))
                                 if sharded else (mean, unbiased))
            new_state = {
                "mean": (1 - bn_momentum) * bn_state["mean"] + bn_momentum * run_mean,
                "var": (1 - bn_momentum) * bn_state["var"] + bn_momentum * run_var,
                "count": bn_state["count"] + 1,
            }
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        if sharded:
            mean, var = tp.my_columns(mean, mesh), tp.my_columns(var, mesh)
        new_state = bn_state
    scale, bias = params["bn"]["scale"], params["bn"]["bias"]
    if sharded:  # whole on every rank: the gradient of its slice sums over them
        scale, bias = (tp.my_columns(tp.copy_to_model(t, mesh), mesh) for t in (scale, bias))
    x32 = (x32 - mean) * torch.rsqrt(var + bn_eps)
    x = (x32 * scale + bias).to(x.dtype)

    x = torch.relu(x)
    if train and dropout_rate > 0.0:
        x = _dropout(x, dropout_rate, generator, mesh if sharded else None)

    logits, _ = _linear(params["linear_1"], x, mesh)
    return logits.float(), new_state
