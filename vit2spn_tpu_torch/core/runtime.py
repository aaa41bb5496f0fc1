"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. With no GPU
and no explicit CPU request they raise: nothing falls back to the CPU
quietly, so a run that reports GPU numbers really ran on the GPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means `cuda`. Raises when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
