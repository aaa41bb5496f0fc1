"""The host data-plane, through the committed native library.

`native/libvit2spn_dataplane.so` (built from native/dataplane.cpp) draws the
seeded Fisher-Yates permutation (splitmix64) that the JAX package's `fit`
uses for its epoch order, gathers uint8 image rows with threads and counts
labels. This shim only loads that library with ctypes, so the port's `fit`
visits samples in the same order as the JAX `fit`; it never builds into
`native/`. Without the library (or with VIT2SPN_NO_NATIVE set) each function
takes numpy's way, as the JAX package does then. Host code, not a kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

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
                lib.vit2spn_gather_u8.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ]
                lib.vit2spn_bincount.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
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


def gather_batch(images: np.ndarray, idx: np.ndarray, out: Optional[np.ndarray] = None,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """out[i] = images[idx[i]], a threaded copy; numpy's fancy indexing (the
    same bytes) without the library, for a non-contiguous or non-uint8 array,
    or for indices out of range, which numpy wraps or refuses."""
    lib = _library()
    idx = np.ascontiguousarray(np.asarray(idx).reshape(-1), dtype=np.int64)
    if (lib is None or images.dtype != np.uint8 or not images.flags.c_contiguous
            or (len(idx) and (idx.min() < 0 or idx.max() >= len(images)))):
        return images[idx]
    if out is None:
        out = np.empty((len(idx),) + images.shape[1:], dtype=np.uint8)
    lib.vit2spn_gather_u8(images.ctypes.data, idx.ctypes.data, out.ctypes.data, len(idx),
                          int(np.prod(images.shape[1:])), n_threads or (os.cpu_count() or 1))
    return out


def bincount(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Occurrences of each class 0 .. num_classes - 1 (int64)."""
    lib = _library()
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    if lib is None:
        return np.bincount(labels, minlength=num_classes).astype(np.int64)
    out = np.empty(num_classes, dtype=np.int64)
    lib.vit2spn_bincount(labels.ctypes.data, len(labels), num_classes, out.ctypes.data)
    return out
