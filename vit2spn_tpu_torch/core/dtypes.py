"""Mixed-precision policy (port of `vit2spn_tpu/core/dtypes.py`).

bf16 compute with fp32 master params; layernorm and softmax statistics in
fp32. Casts are explicit (`.to(dtype)` at each use), not `torch.autocast`, so the backbone kernel sees exactly the dtypes the Pallas
kernel sees: LN params fp32, matmul weights and biases in compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # Softmax / layernorm statistics always accumulate in fp32.
    reduce_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_str(compute: str) -> "DTypePolicy":
        dtype = getattr(torch, compute, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown compute dtype {compute!r}")
        return DTypePolicy(compute_dtype=dtype)

    def cast_to_compute(self, tree):
        """Every floating tensor of a (nested dict, list or tuple) tree in the
        compute dtype; other leaves as they are."""
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        """The same in the param dtype."""
        return _cast_floating(tree, self.param_dtype)


def _cast_floating(tree, dtype: torch.dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_cast_floating(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree


FP32 = DTypePolicy(compute_dtype=torch.float32)
BF16 = DTypePolicy()
