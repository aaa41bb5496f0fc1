"""Multi-head self-attention core (port of `vit2spn_tpu/ops/attention.py`).

Two implementations, under the JAX names, for the per-op block
(models/vit.py::_block):

  * `mha_xla` (impl="xla", also named `mha_plain`): plain PyTorch, softmax
    statistics in fp32 regardless of input dtype, the probabilities rounded
    to the value dtype before P.V, as the JAX version does;
  * `mha_pallas` (impl="pallas", ops/flash_attention.py): the hand-written
    kernel on CUDA with P and dS in fp32, its plain twin on the CPU.

`multi_head_attention` takes "xla" unless `impl=` names another, as the
JAX one does. The fused block kernels (ops/fused_block.py) carry their own
attention; `default_model_impl` names the trainers' default path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def acc(t: torch.Tensor) -> torch.Tensor:
    """t widened to the plain versions' accumulation type: fp32 for bf16 and
    fp32 inputs, fp64 for fp64 (the float64 reference the fp32 kernels are
    held against on the card)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, S, H, Dh) tensors; returns (B, S, H, Dh)."""
    head_dim = q.shape[-1]
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", acc(q), acc(k))
    probs = torch.softmax(scores * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", acc(probs.to(v.dtype)), acc(v))
    return out.to(v.dtype)


mha_xla = mha_plain  # the JAX package's name


def default_model_impl() -> Optional[str]:
    """The whole-model path the trainers and model functions take when
    `attn_impl` is None: "fused", the port's kernels on CUDA and their plain
    twins on the CPU (the JAX package takes its fused Pallas kernel on a TPU
    and XLA elsewhere)."""
    return "fused"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: Optional[str] = None) -> torch.Tensor:
    """Attention over (B, S, H, Dh) through `impl`: "xla" (`mha_xla`, the
    default) or "pallas" (`mha_pallas`). The port has no interpret mode: on
    the CPU "pallas" runs the kernels' plain twins."""
    impl = impl or "xla"
    if impl == "xla":
        return mha_plain(q, k, v)
    if impl == "pallas":
        from vit2spn_tpu_torch.ops.flash_attention import mha_pallas

        return mha_pallas(q, k, v)
    raise ValueError(f"unknown attention impl {impl!r}")
