"""Stratified k-fold splitting (StratifiedKFold(shuffle=True, random_state=42)
call at octmnist_ft_vit2spn.py:171-177): a copy of
`vit2spn_tpu/evals/kfold.py`, which the port may not import. The same labels
and seed give the same folds, index for index, in both packages
(tests/test_torch_evals.py), so a multitrial run moves between them.

Own implementation (sklearn-free runtime). Exact index-for-index parity with
sklearn's internal shuffling is not required for metric parity (the
reference's own folds depend on torch dataloader ordering anyway); the class
proportions per fold match sklearn's stratification guarantee.
"""

from __future__ import annotations

import warnings
from typing import Iterator, Tuple

import numpy as np


def stratified_kfold(
    labels: np.ndarray, n_splits: int, seed: int = 42, shuffle: bool = True
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (train_idx, val_idx) with per-class proportional allocation.

    sklearn-matching edge semantics (the reference calls
    StratifiedKFold): n_splits > n_samples is a ValueError; a class with
    fewer members than n_splits warns but proceeds. The round-robin deal
    CONTINUES across classes, so overall fold sizes differ by <=1 and no
    fold is ever empty while n >= n_splits — a fresh per-class deal would
    leave trailing folds empty when every class has < n_splits members
    (seen on-chip: 21 samples / 4 classes / 10 folds gave empty val folds
    and an opaque crash deep in the eval scan)."""
    labels = np.asarray(labels).reshape(-1)
    n = len(labels)
    if n_splits > n:
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than"
            f" the number of samples: n_samples={n}."
        )
    _, counts = np.unique(labels, return_counts=True)
    if counts.min() < n_splits:
        warnings.warn(
            f"The least populated class has only {counts.min()} members, "
            f"which is less than n_splits={n_splits}.",
            UserWarning, stacklevel=2,
        )
    rng = np.random.default_rng(seed)
    fold_of = np.empty(n, dtype=np.int64)
    start = 0
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        if shuffle:
            idx = rng.permutation(idx)
        # deal class members round-robin into folds, continuing from where
        # the previous class stopped: per class each fold gets floor/ceil
        # (m/k) members (stratification +-1), and the global deal is one
        # contiguous round-robin over all n items (fold sizes +-1, no empties)
        fold_of[idx] = (start + np.arange(len(idx))) % n_splits
        start = (start + len(idx)) % n_splits
    for f in range(n_splits):
        val = np.flatnonzero(fold_of == f)
        train = np.flatnonzero(fold_of != f)
        yield train, val


def stratified_holdout(
    labels: np.ndarray, fractions: Tuple[float, ...], seed: int = 42
) -> Tuple[np.ndarray, ...]:
    """Stratified multi-way split, e.g. fractions=(0.7, 0.2, 0.1) reproduces
    the OCTID/UCSD 70/20/10 protocol (octird_ft_vit2spn.py:72-74, implemented
    there as two chained train_test_splits)."""
    labels = np.asarray(labels).reshape(-1)
    assert abs(sum(fractions) - 1.0) < 1e-6
    rng = np.random.default_rng(seed)
    parts = [[] for _ in fractions]
    for cls in np.unique(labels):
        idx = rng.permutation(np.flatnonzero(labels == cls))
        bounds = np.round(np.cumsum(fractions) * len(idx)).astype(int)
        start = 0
        for i, b in enumerate(bounds):
            parts[i].append(idx[start:b])
            start = b
    return tuple(np.sort(np.concatenate(p)) for p in parts)
