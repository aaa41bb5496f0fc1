"""Datasets and the augmentation, under the JAX package's export names.
Each loads on first access."""

__all__ = [
    "augment_batch",
    "dual_view_batch",
    "Dataset",
    "load_dataset",
    "register_dataset",
]

_LAZY = {"augment_batch": "augment", "dual_view_batch": "augment",
         "Dataset": "datasets", "load_dataset": "datasets", "register_dataset": "datasets"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
