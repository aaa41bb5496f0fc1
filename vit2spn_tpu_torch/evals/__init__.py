"""Evaluation: metrics, k-fold splits and the CV protocol, under the JAX
package's export names. The protocol (which pulls in the trainer) loads on
first access, so importing `metrics` or `kfold` stays numpy-only."""

from vit2spn_tpu_torch.evals.kfold import stratified_kfold
from vit2spn_tpu_torch.evals.metrics import (
    classification_summary,
    confusion_matrix,
    mean_auc,
    per_class_roc,
    sensitivity_specificity,
)

__all__ = [
    "classification_summary",
    "confusion_matrix",
    "mean_auc",
    "per_class_roc",
    "sensitivity_specificity",
    "stratified_kfold",
    "CVResult",
    "run_cv_protocol",
]


def __getattr__(name):
    if name in ("CVResult", "run_cv_protocol"):
        from vit2spn_tpu_torch.evals import protocol

        return getattr(protocol, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
