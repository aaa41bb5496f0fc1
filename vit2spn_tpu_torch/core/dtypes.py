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


FP32 = DTypePolicy(compute_dtype=torch.float32)
BF16 = DTypePolicy()
