"""Configs, presets and the dtype policy, under the JAX package's export
names. `DTypePolicy` (which imports torch) loads on first access, so the
configs and presets stay torch-free."""

from vit2spn_tpu_torch.core.config import (
    AugmentConfig,
    DataConfig,
    FineTuneConfig,
    MeshConfig,
    SSPConfig,
    ViTConfig,
)
from vit2spn_tpu_torch.core.presets import PRESETS, get_preset

__all__ = [
    "AugmentConfig",
    "DataConfig",
    "FineTuneConfig",
    "MeshConfig",
    "SSPConfig",
    "ViTConfig",
    "DTypePolicy",
    "PRESETS",
    "get_preset",
]


def __getattr__(name):
    if name == "DTypePolicy":
        from vit2spn_tpu_torch.core.dtypes import DTypePolicy

        return DTypePolicy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
