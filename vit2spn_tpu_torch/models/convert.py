"""Weight and state carry between the JAX package's trees and the port's.

`from_jax` turns the JAX package's parameters, as numpy arrays (for example
`jax.device_get(trainer.state.params)`), into the port's: a `DualStreamParams`
(or any NamedTuple with `online` / `heads` / `target`) becomes the port's
`DualStreamParams`, and a backbone dict stays a dict. The layouts are the
same on both sides, so this is a leaf-by-leaf copy into tensors; it needs no
JAX and recognises the tree by its structure alone.

`finetune_from_jax` and `finetune_to_jax` carry a whole fine-tune state
(backbone, classifier head, BatchNorm running statistics and Adam's state)
each way, so both packages can start from one state and be compared leaf by
leaf.
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


def finetune_from_jax(state, device=None):
    """The JAX `FineTuneState` as numpy (`jax.device_get(trainer.state)`) ->
    the port's `FineTuneState` on `device` (default `cuda`). The JAX optax
    state is (the masked add_decayed_weights state, which holds no arrays,
    ScaleByAdamState(count, mu, nu) over (backbone, head)); the port's is
    ((), {"count", "mu", "nu"}), whose leaves carry the same names in a
    checkpoint (`opt_state/1/mu/0/...`)."""
    from vit2spn_tpu_torch.train.finetune import FineTuneState

    dev = resolve_device(device)
    adam = state.opt_state[1]
    return FineTuneState(
        backbone=_tree(state.backbone, dev),
        head=_tree(state.head, dev),
        bn_state=_tree(state.bn_state, dev),
        opt_state=((), {
            "count": _leaf(adam.count, dev),
            "mu": tuple(_tree(t, dev) for t in adam.mu),
            "nu": tuple(_tree(t, dev) for t in adam.nu),
        }),
    )


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return tree.detach().cpu().numpy().copy()


def finetune_to_jax(state):
    """The port's `FineTuneState` -> the same structure with numpy leaves,
    whose leaves come in the order of the JAX `FineTuneState`'s (dict keys
    sorted; count, mu, nu), so
    `jax.tree.unflatten(jax.tree.structure(jax_state), jax.tree.leaves(out))`
    rebuilds the JAX state."""
    return _numpy(state)
