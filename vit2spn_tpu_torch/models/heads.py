"""Projection / prediction heads (port of `vit2spn_tpu/models/heads.py`).

  * projection_head: Linear(384->1024) ReLU Dropout(.3) Linear(1024->128)
    (ssp_vit2spn_tiny.py:133-138; single-stream input 192).
  * prediction_head: Linear(128->128) ReLU Linear(128->128)
    (ssp_vit2spn_tiny.py:139-143).

Params are dicts `linear_<i>/{w (in, out), b}` in the JAX layout.
Initialization follows torch.nn.Linear defaults (U(+-1/sqrt(fan_in)) for
weights and biases). The fine-tune classifier head comes with the fine-tune
slice of the port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


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


def mlp_head_apply(
    params: dict,
    x: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    dropout_after_layer: int = -1,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """Linear -> ReLU [-> Dropout] -> ... -> Linear (no activation on last).
    Dropout is active only with `train=True` and draws its mask from the
    explicit `generator` (on x's device)."""
    n = len(params)
    for i in range(n):
        p = params[f"linear_{i}"]
        x = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
        if i < n - 1:
            x = torch.relu(x)
            if train and dropout_rate > 0.0 and i == dropout_after_layer:
                if generator is None:
                    raise ValueError("dropout in train mode needs a generator")
                keep = 1.0 - dropout_rate
                mask = torch.rand(x.shape, generator=generator,
                                  device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
    return x
