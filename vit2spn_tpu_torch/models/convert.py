"""Weight carry from the JAX package's parameter trees.

`from_jax` turns the JAX package's parameters, as numpy arrays (for example
`jax.device_get(trainer.state.params)`), into the port's: a `DualStreamParams`
(or any NamedTuple with `online` / `heads` / `target`) becomes the port's
`DualStreamParams`, and a backbone dict stays a dict. The layouts are the
same on both sides, so this is a leaf-by-leaf copy into tensors; it needs no
JAX and recognises the tree by its structure alone.
"""

from __future__ import annotations

import numpy as np
import torch

from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.models.ssp import DualStreamParams


def _leaf(a, device) -> torch.Tensor:
    # np.array copies: torch.from_numpy wants a writeable buffer, and the
    # JAX side's host arrays may be read-only
    return torch.from_numpy(np.array(a)).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def from_jax(tree, device=None):
    """JAX-side params (numpy leaves) -> the port's params on `device`
    (default `cuda`)."""
    dev = resolve_device(device)
    if hasattr(tree, "_fields") and {"online", "heads", "target"} <= set(tree._fields):
        return DualStreamParams(
            online=_tree(tree.online, dev),
            heads=_tree(tree.heads, dev),
            target=_tree(tree.target, dev),
        )
    if isinstance(tree, dict):
        return _tree(tree, dev)
    raise TypeError(f"from_jax takes a DualStreamParams or a dict, got {type(tree)}")
