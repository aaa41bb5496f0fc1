"""Logging and FLOP counting, under the JAX package's export names. Each
loads on first access."""

__all__ = ["MetricLogger", "forward_flops"]

_LAZY = {"MetricLogger": "logging", "forward_flops": "flops"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
