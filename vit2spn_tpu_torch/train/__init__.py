"""Trainers and their controllers, under the JAX package's export names.
The trainers load on first access, so importing the package (or
`train.optim`) does not build them."""

from vit2spn_tpu_torch.train.optim import (
    EarlyStopping,
    ReduceLROnPlateau,
    balanced_class_weights,
)

__all__ = [
    "EarlyStopping",
    "ReduceLROnPlateau",
    "balanced_class_weights",
    "SSPTrainer",
    "SSPTrainState",
    "FineTuneTrainer",
    "FineTuneState",
]

_LAZY = {"SSPTrainer": "ssp", "SSPTrainState": "ssp",
         "FineTuneTrainer": "finetune", "FineTuneState": "finetune"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
