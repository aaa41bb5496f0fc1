"""The fine-tune and cross-validation protocol (port of
`vit2spn_tpu/evals/protocol.py`).

One function replaces the module-level flow of every `*_ft_*.py` reference
script (octmnist_ft_vit2spn.py:171-227, octird_ft_vit2spn.py:209-264,
ucsdoct_ft_vit2spn.py:255-304, multitrial/*):

  1. subset selection — OCTMNIST: a random fraction of the train split and a
     random test subset (:52-59); OCTID/UCSD: an absolute-size subset and a
     stratified 70/20/10 holdout whose 10% is the test set
     (octird_ft_vit2spn.py:72-74).
  2. stratified k-fold CV over the subset; per fold: balanced class weights
     from the train fold's labels, a fresh model from the SSP export,
     fine-tuning with the plateau scheduler and early stop, per-class val
     ROC and mAUC.
  3. the best fold's model (by val mAUC, octmnist_ft_vit2spn.py:200-202) on
     the held-out test set: confusion matrix, classification report (and the
     multitrial sensitivity, specificity and confidence).
  4. the fold mAUCs' mean and std.

The subsets and folds are numpy draws, the same as the JAX package's for the
same seed. One best trainer is held at a time and every other fold's is
freed before the next is built, so device memory does not grow with the
folds; on CUDA each fold's peak is logged (`fold_memory`).

Faithfulness note (kept, it defines the numbers): for OCTID/UCSD the CV
folds are drawn from the FULL subset, which overlaps the holdout test split
(octird_ft_vit2spn.py:215 uses subset_dataset, not train_dataset).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from vit2spn_tpu_torch.core.config import FineTuneConfig
from vit2spn_tpu_torch.core.runtime import resolve_device
from vit2spn_tpu_torch.data.datasets import Dataset, load_dataset
from vit2spn_tpu_torch.evals.kfold import stratified_holdout, stratified_kfold
from vit2spn_tpu_torch.evals.metrics import classification_summary, mean_auc, per_class_roc
from vit2spn_tpu_torch.parallel.mesh import current_rank, make_mesh
from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
from vit2spn_tpu_torch.train.optim import balanced_class_weights
from vit2spn_tpu_torch.utils.logging import MetricLogger


@dataclass
class CVResult:
    fold_aucs: List[float]
    best_fold: int
    best_auc: float
    test_summary: dict
    fold_rocs: Dict[int, tuple] = field(default_factory=dict)
    # per-fold TEST metrics (multitrial protocol): every fold's model is
    # evaluated on the held-out test set (multitrial/octmnist_ft_vit2spn.py:
    # 230-241); filled by run_cv_protocol(per_fold_test=True).
    fold_test_metrics: List[dict] = field(default_factory=list)

    @property
    def mean_auc(self) -> float:
        return float(np.mean(self.fold_aucs))

    @property
    def std_auc(self) -> float:
        return float(np.std(self.fold_aucs))

    def multitrial_aggregate(self) -> Dict[str, dict]:
        """mean±std ACROSS THE FOLDS of one run — the published estimator
        (multitrial/octmnist_ft_vit2spn.py:242-263): top-1 accuracy /
        sensitivity / specificity / confidence from each fold's test-set
        evaluation, mAUC from each fold's val ROC."""
        if not self.fold_test_metrics:
            raise ValueError("run_cv_protocol(per_fold_test=True) first")
        rows = [dict(m, mauc=a) for m, a in
                zip(self.fold_test_metrics, self.fold_aucs)]
        return {
            k: {"mean": float(np.mean([r[k] for r in rows])),
                "std": float(np.std([r[k] for r in rows]))}
            for k in rows[0]
        }


def select_subsets(cfg: FineTuneConfig, ds: Dataset, seed: Optional[int] = None):
    """Returns (cv_dataset, test_dataset) per the dataset's protocol."""
    data = cfg.data
    seed = cfg.seed if seed is None else seed
    rng = np.random.default_rng(seed)
    if data.subset_fraction is not None:
        train = ds.split("train") if "train" in ds.splits else ds
        test = ds.split("test") if "test" in ds.splits else ds
        n_sub = int(len(train) * data.subset_fraction)
        sub_idx = rng.choice(len(train), size=n_sub, replace=False)
        cv_ds = train.subset(sub_idx, "cv")
        n_test = min(data.test_subset_size or len(test), len(test))
        test_idx = rng.choice(len(test), size=n_test, replace=False)
        test_ds = test.subset(test_idx, "test")
        return cv_ds, test_ds
    # folder protocol: absolute subset + 70/20/10 holdout, CV over full subset
    pool = ds.split("all") if "all" in ds.splits else ds
    n_sub = min(data.subset_size or len(pool), len(pool))
    sub_idx = rng.choice(len(pool), size=n_sub, replace=False)
    subset = pool.subset(sub_idx, "subset")
    _, _, test_idx = stratified_holdout(subset.labels, (0.7, 0.2, 0.1), seed=seed)
    return subset, subset.subset(test_idx, "test")


def run_cv_protocol(
    cfg: FineTuneConfig,
    dataset: Optional[Dataset] = None,
    backbone_params: Optional[dict] = None,
    logger: Optional[MetricLogger] = None,
    epochs: Optional[int] = None,
    trial_seed: Optional[int] = None,
    mesh=None,
    eval_augment: bool = True,
    per_fold_test: bool = False,
    trial: int = 0,
    attn_impl: Optional[str] = None,
    device=None,
) -> CVResult:
    """`trial_seed` re-draws the data (subsets and fold assignment);
    `trial` re-draws only the training randomness with the data held fixed —
    what the reference's repeated "retraining runs" vary (its subset and
    folds are pinned at seed 42; multitrial/octmnist_ft_vit2spn.py:28,58,193).
    Runs on `device` (default `cuda`). Every fold's trainer takes `mesh`
    (parallel/mesh.py); without one, one mesh over cfg.mesh is made here for
    all the folds, so the folds make no process groups of their own."""
    logger = logger or MetricLogger(echo=True)
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(cfg.mesh.model_parallel, cfg.mesh.data_axis, cfg.mesh.model_axis,
                         device=dev)
    ds = dataset if dataset is not None else load_dataset(
        cfg.data.name, root=cfg.data.root
    )
    num_classes = ds.num_classes
    cv_ds, test_ds = select_subsets(cfg, ds, seed=trial_seed)
    logger.log("protocol", dataset=ds.name, cv_size=len(cv_ds), test_size=len(test_ds))

    fold_aucs: List[float] = []
    fold_rocs: Dict[int, tuple] = {}
    fold_test_metrics: List[dict] = []
    best_auc, best_fold, best_trainer = 0.0, -1, None
    seed = cfg.seed if trial_seed is None else trial_seed
    test_weights = balanced_class_weights(test_ds.labels, num_classes)

    trainer = None
    for fold, (train_idx, val_idx) in enumerate(
        stratified_kfold(cv_ds.labels, cfg.k_folds, seed=seed)
    ):
        train_fold = cv_ds.subset(train_idx)
        val_fold = cv_ds.subset(val_idx)
        weights = balanced_class_weights(train_fold.labels, num_classes)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        trainer = None  # free the last fold's model before the next is built
        trainer = FineTuneTrainer(
            cfg,
            num_classes=num_classes,
            backbone_params=backbone_params,
            logger=logger,
            fold=fold,
            attn_impl=attn_impl,
            eval_augment=eval_augment,
            trial=trial,
            device=dev,
            mesh=mesh,
        )
        trainer.fit(train_fold, val_fold, weights, epochs=epochs,
                    tag=f"fold{fold}")

        _, probs, labels = trainer.evaluate(val_fold, weights)
        fold_rocs[fold] = per_class_roc(labels, probs)
        fold_mauc = mean_auc(labels, probs)
        fold_aucs.append(fold_mauc)
        logger.log("fold_result", fold=fold, mauc=fold_mauc)

        if per_fold_test:
            # multitrial protocol: EVERY fold's model gets a test-set
            # evaluation; mean±std across folds is the published estimator
            # (multitrial/octmnist_ft_vit2spn.py:230-241,249-263).
            _, tprobs, tlabels = trainer.evaluate(test_ds, test_weights)
            ts = classification_summary(tlabels, tprobs, ds.class_names)
            fold_test_metrics.append(dict(
                accuracy=ts["accuracy"],
                sensitivity=ts["sensitivity"],
                specificity=ts["specificity"],
                confidence=ts["mean_confidence"],
            ))
            logger.log("fold_test", fold=fold, **fold_test_metrics[-1])

        if fold_mauc > best_auc:
            best_auc, best_fold, best_trainer = fold_mauc, fold, trainer
        if dev.type == "cuda":
            logger.log("fold_memory", fold=fold,
                       peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                       allocated_bytes=torch.cuda.memory_allocated(dev))

    if best_trainer is None:
        # every fold's mAUC was NaN (a class absent from val labels) — the
        # reference would crash here; fall back to the last fold with a warning
        best_trainer, best_fold = trainer, fold
        logger.log("warning", message="all fold mAUCs NaN; using last fold")
    trainer = None
    _, probs, labels = best_trainer.evaluate(test_ds, test_weights)
    summary = classification_summary(labels, probs, ds.class_names)
    logger.log(
        "cv_summary",
        mean_auc=float(np.mean(fold_aucs)),
        std_auc=float(np.std(fold_aucs)),
        best_auc=best_auc,
        test_accuracy=summary["accuracy"],
        test_mauc=summary["mean_auc"],
    )
    return CVResult(
        fold_aucs=fold_aucs,
        best_fold=best_fold,
        best_auc=best_auc,
        test_summary=summary,
        fold_rocs=fold_rocs,
        fold_test_metrics=fold_test_metrics,
    )


def _trial_state_key(cfg: FineTuneConfig, epochs) -> dict:
    """Resume key = every result-affecting config field (the full config
    tree minus the mesh) plus the epochs override, the JAX package's key
    field for field, so a multitrial_state.json moves between the packages.
    Any change invalidates the state file rather than silently mixing
    differently-configured trials."""
    key = dataclasses.asdict(cfg)
    key.pop("mesh", None)
    key["epochs_override"] = epochs
    # v2: trials hold data fixed and vary training stochasticity (the
    # reference's estimator)
    key["estimator"] = 2
    # fold algorithm v2: the stratified deal continues across classes
    # (evals/kfold.py)
    key["fold_algorithm"] = 2
    # normalize through JSON (tuples -> lists) so the in-memory key compares
    # equal to one read back from the state file
    return json.loads(json.dumps(key))


def _load_trial_state(path: str, cfg: FineTuneConfig, epochs=None) -> list:
    """Completed-trial records from a previous (killed) run — resumable
    multitrial."""
    if not (path and os.path.exists(path)):
        return []
    with open(path) as f:
        state = json.load(f)
    if state.get("key") != _trial_state_key(cfg, epochs):
        return []
    return state.get("trials", [])


def _save_trial_state(path: str, cfg: FineTuneConfig, trials: list,
                      epochs=None) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"key": _trial_state_key(cfg, epochs), "trials": trials}, f)
    os.replace(tmp, path)  # atomic like train/checkpoint.py


def run_multitrial(
    cfg: FineTuneConfig,
    dataset: Optional[Dataset] = None,
    backbone_params: Optional[dict] = None,
    logger: Optional[MetricLogger] = None,
    epochs: Optional[int] = None,
    mesh=None,
    resume_path: Optional[str] = None,
    attn_impl: Optional[str] = None,
    device=None,
) -> dict:
    """multitrial/*: one run evaluates EVERY fold's model on the held-out test
    set and reports mean±std ACROSS THE FOLDS of top-1 / sensitivity /
    specificity / confidence (+ val mAUC across folds) — the published
    estimator (multitrial/octmnist_ft_vit2spn.py:230-241,249-263).

    `cfg.num_trials > 1` repeats that whole run with the data held fixed
    (same subsets, same folds) while the training randomness is re-drawn per
    trial, what varies between the reference's "5 retraining runs"
    (README.md:46); `across_trials` then reports mean±std of the per-trial
    means.

    `resume_path`: JSON file with each completed trial — a killed run resumes
    at the next trial (trial results are deterministic given the per-trial
    streams, so resumed aggregates equal an uninterrupted run's)."""
    logger = logger or MetricLogger(echo=True)
    if mesh is None:  # one for every trial and fold
        mesh = make_mesh(cfg.mesh.model_parallel, cfg.mesh.data_axis, cfg.mesh.model_axis,
                         device=resolve_device(device))
    trials = _load_trial_state(resume_path, cfg, epochs) if resume_path else []
    if trials:
        logger.log("multitrial_resume", completed=len(trials),
                   total=cfg.num_trials, path=resume_path)
    for trial in range(len(trials), cfg.num_trials):
        res = run_cv_protocol(
            cfg, dataset, backbone_params, logger, epochs, mesh=mesh,
            per_fold_test=True, trial=trial, attn_impl=attn_impl, device=device,
        )
        agg = res.multitrial_aggregate()
        trials.append({
            "fold_metrics": res.fold_test_metrics,
            "fold_aucs": res.fold_aucs,
            "aggregate": agg,
        })
        logger.log("trial", trial=trial, **{
            f"{k}_{s}": v[s] for k, v in agg.items() for s in ("mean", "std")
        })
        if resume_path and current_rank() == 0:  # every rank holds the same trials
            _save_trial_state(resume_path, cfg, trials, epochs)
    out = {"trials": trials, "aggregate": trials[0]["aggregate"]}
    if cfg.num_trials > 1:
        keys = trials[0]["aggregate"].keys()
        out["across_trials"] = {
            k: {
                "mean": float(np.mean([t["aggregate"][k]["mean"] for t in trials])),
                "std": float(np.std([t["aggregate"][k]["mean"] for t in trials])),
            }
            for k in keys
        }
    logger.log("multitrial_summary", **{
        f"{k}_{s}": v[s]
        for k, v in out.get("across_trials", out["aggregate"]).items()
        for s in ("mean", "std")
    })
    return out
