"""Multi-head self-attention core, plain PyTorch (port of
`vit2spn_tpu/ops/attention.py::mha_xla`).

Softmax statistics in fp32 regardless of input dtype; the probabilities are
rounded to the value dtype before P.V, as the JAX version does. The fused
backbone kernel (ops/fused_block.py) carries its own attention; this is the
standalone form for callers outside the backbone.
"""

from __future__ import annotations

import math

import torch


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, S, H, Dh) tensors; returns (B, S, H, Dh)."""
    head_dim = q.shape[-1]
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
