"""Evaluation metrics (C12): a copy of `vit2spn_tpu/evals/metrics.py`, which
the port may not import (tests/test_torch_evals.py holds the two equal).

Self-contained numpy implementations of every metric the reference computes
via sklearn (octmnist_ft_vit2spn.py:129-168; multitrial sens/spec at
multitrial/octmnist_ft_vit2spn.py:168-191). No sklearn dependency at runtime.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Binary ROC via score-sorted cumulative counts (sklearn-equivalent with
    drop_intermediate=False). Returns (fpr, tpr, thresholds).

    A class with no positive (or no negative) samples yields NaN tpr (fpr),
    matching sklearn.metrics.roc_curve; the NaN then propagates through auc()
    and mean_auc() exactly as the reference's
    `np.mean(list(roc_auc.values()))` would (octmnist_ft_vit2spn.py:148)."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx].astype(float)
    fps = (idx + 1) - tps
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, y_score[idx]]
    with np.errstate(invalid="ignore", divide="ignore"):
        fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan)
        tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan)
    return fpr, tpr, thresholds


# np.trapezoid is NumPy >= 2.0; np.trapz is its (deprecated) 1.x spelling.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def auc(x: np.ndarray, y: np.ndarray) -> float:
    return float(_trapezoid(y, x))


def per_class_roc(
    labels: np.ndarray, probs: np.ndarray
) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray], Dict[int, float]]:
    """One-vs-rest ROC per class (compute_auc_and_plot_fold,
    octmnist_ft_vit2spn.py:143-148)."""
    num_classes = probs.shape[1]
    one_hot = np.eye(num_classes)[labels]
    fpr, tpr, roc_auc = {}, {}, {}
    for i in range(num_classes):
        fpr[i], tpr[i], _ = roc_curve(one_hot[:, i], probs[:, i])
        roc_auc[i] = auc(fpr[i], tpr[i])
    return fpr, tpr, roc_auc


def mean_auc(labels: np.ndarray, probs: np.ndarray) -> float:
    """mAUC = unweighted mean of per-class one-vs-rest AUCs (:148)."""
    _, _, roc_auc = per_class_roc(labels, probs)
    return float(np.mean(list(roc_auc.values())))


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, num_classes: int):
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def sensitivity_specificity(cm: np.ndarray) -> Tuple[float, float]:
    """Macro-averaged one-vs-rest sensitivity/specificity from the confusion
    matrix (multitrial/octmnist_ft_vit2spn.py:176-189)."""
    sens, spec = [], []
    total = cm.sum()
    for i in range(cm.shape[0]):
        tp = cm[i, i]
        fn = cm[i, :].sum() - tp
        fp = cm[:, i].sum() - tp
        tn = total - tp - fn - fp
        sens.append(tp / (tp + fn) if (tp + fn) > 0 else 0.0)
        spec.append(tn / (tn + fp) if (tn + fp) > 0 else 0.0)
    return float(np.mean(sens)), float(np.mean(spec))


def classification_summary(
    labels: np.ndarray, probs: np.ndarray, class_names: List[str]
) -> dict:
    """Everything evaluate_test_data prints (octmnist_ft_vit2spn.py:151-168)
    plus the multitrial metrics, as one structured dict."""
    preds = probs.argmax(axis=1)
    k = len(class_names)
    cm = confusion_matrix(labels, preds, k)
    per_class = {}
    for i, name in enumerate(class_names):
        tp = cm[i, i]
        support = cm[i, :].sum()
        pred_pos = cm[:, i].sum()
        precision = tp / pred_pos if pred_pos else 0.0
        recall = tp / support if support else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        per_class[name] = {
            "precision": float(precision),
            "recall": float(recall),
            "f1": float(f1),
            "support": int(support),
        }
    sens, spec = sensitivity_specificity(cm)
    macro = {
        "precision": float(np.mean([v["precision"] for v in per_class.values()])),
        "recall": float(np.mean([v["recall"] for v in per_class.values()])),
        "f1": float(np.mean([v["f1"] for v in per_class.values()])),
    }
    return {
        "accuracy": float((preds == labels).mean()),
        "mean_auc": mean_auc(labels, probs),
        "confusion_matrix": cm,
        "per_class": per_class,
        "macro": macro,
        "sensitivity": sens,
        "specificity": spec,
        "mean_confidence": float(probs.max(axis=1).mean()),
    }


def classification_report_text(summary: dict, digits: int = 2) -> str:
    """sklearn-format text classification report from a
    `classification_summary` dict — the artifact the reference PRINTS at
    test evaluation (octmnist_ft_vit2spn.py:168,
    `print(classification_report(labels, preds, target_names=classes))`).
    Byte-identical to sklearn's renderer for the same inputs
    (the JAX package's tests/test_metrics.py),
    so downstream tooling that parses the reference's stdout keeps working.
    """
    per_class = summary["per_class"]
    total_support = sum(v["support"] for v in per_class.values())
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(
        max(len(name) for name in per_class),
        len("weighted avg"),
        digits,
    )
    head_fmt = "{:>{width}} " + " {:>9}" * len(headers)
    report = head_fmt.format("", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for name, v in per_class.items():
        report += row_fmt.format(
            name, v["precision"], v["recall"], v["f1"], v["support"],
            width=width, digits=digits,
        )
    report += "\n"
    acc_fmt = ("{:>{width}} " + " {:>9.{digits}}" * 2
               + " {:>9.{digits}f}" + " {:>9}\n")
    report += acc_fmt.format(
        "accuracy", "", "", summary["accuracy"], total_support,
        width=width, digits=digits,
    )
    m = summary["macro"]
    report += row_fmt.format(
        "macro avg", m["precision"], m["recall"], m["f1"], total_support,
        width=width, digits=digits,
    )
    if total_support:
        wavg = {
            k: sum(v[k] * v["support"] for v in per_class.values())
            / total_support
            for k in ("precision", "recall", "f1")
        }
    else:
        wavg = {"precision": 0.0, "recall": 0.0, "f1": 0.0}
    report += row_fmt.format(
        "weighted avg", wavg["precision"], wavg["recall"], wavg["f1"],
        total_support, width=width, digits=digits,
    )
    return report
