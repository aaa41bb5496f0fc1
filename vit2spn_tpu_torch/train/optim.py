"""Host-side training controllers and class weighting (a copy of
`vit2spn_tpu/train/optim.py`, which the port may not import).

torch semantics, as in the JAX package:
  * ReduceLROnPlateau(mode="min", factor, patience), octmnist_ft_vit2spn.py:193
    (UCSD variant patience=2 factor=0.5, ucsdoct_ft_vit2spn.py:288): the lr
    drops on the (patience+1)-th consecutive non-improving epoch, and an
    improvement must beat torch's default threshold=1e-4 in 'rel' mode
    (metric < best * (1 - 1e-4)). The trainer sets the scale into Adam's
    param groups each epoch.
  * Early stopping on val loss (fine_tune_model, octmnist_ft_vit2spn.py:
    90-126). The controller can carry a best-state snapshot; the trainer
    takes one only when cfg.restore_best_weights asks for a real restore
    (the reference's own restore is a no-op, train/finetune.py).
  * sklearn-style balanced class weights: n / (k * bincount)
    (compute_class_weight("balanced"), octmnist_ft_vit2spn.py:185-187).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ReduceLROnPlateau:
    factor: float = 0.1
    patience: int = 3
    min_lr: float = 0.0
    # torch defaults: threshold=1e-4, threshold_mode='rel' — improvement means
    # metric < best * (1 - threshold) (mode='min'); 'abs' means best - threshold.
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    scale: float = 1.0
    best: float = float("inf")
    num_bad: int = 0

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Record an epoch's val metric; returns the current lr scale."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.num_bad = 0
        return self.scale


@dataclass
class EarlyStopping:
    patience: int = 3
    best: float = float("inf")
    counter: int = 0
    best_state: object = None
    should_stop: bool = False

    def step(self, metric: float, state) -> bool:
        """Returns True when training should stop. Keeps the best state
        (host copy) for restore — octmnist_ft_vit2spn.py:117-126."""
        if metric < self.best:
            self.best = metric
            self.best_state = state
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop


def balanced_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """n_samples / (n_classes * bincount), over the classes present in
    `labels`; absent classes get weight 0 (they cannot occur in the loss).
    Equals sklearn compute_class_weight("balanced") whenever every class is
    present (the JAX package's documented deviation otherwise, PARITY.md).
    Labels outside range(num_classes) are not counted, as the JAX package's
    native count does."""
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    in_range = labels[(labels >= 0) & (labels < num_classes)]
    counts = np.bincount(in_range, minlength=num_classes).astype(np.float64)
    weights = np.zeros(num_classes)
    present = counts > 0
    weights[present] = len(labels) / (present.sum() * counts[present])
    return weights.astype(np.float32)
