"""The host data-plane's epoch shuffle, through the committed native library.

`native/libvit2spn_dataplane.so` (built from native/dataplane.cpp) draws the
seeded Fisher-Yates permutation (splitmix64) that the JAX package's `fit`
uses for its epoch order. This shim only loads that library with ctypes, so
the port's `fit` visits samples in the same order as the JAX `fit`; it never
builds into `native/`. Without the library (or with VIT2SPN_NO_NATIVE set)
it draws numpy's permutation, as the JAX package does then. Host code, not a
kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libvit2spn_dataplane.so"
_LIB = None
_LOCK = threading.Lock()


def _library():
    """The loaded library, or None for the numpy path (memoized)."""
    global _LIB
    if os.environ.get("VIT2SPN_NO_NATIVE"):
        return None
    with _LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(str(_LIB_PATH))
                lib.vit2spn_shuffled_indices.argtypes = [
                    ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p,
                ]
                _LIB = lib
            except OSError:
                _LIB = False
    return _LIB or None


def available() -> bool:
    return _library() is not None


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic permutation of range(n) for `seed` (int64)."""
    lib = _library()
    if lib is None:
        return np.random.default_rng(seed).permutation(n)
    out = np.empty(n, dtype=np.int64)
    lib.vit2spn_shuffled_indices(n, np.uint64(seed), out.ctypes.data)
    return out
