"""The port's host-side fine-tune pieces against the JAX package's, on the
same inputs: the training controllers and class weights (train/optim.py),
the k-fold and holdout splits, the metrics and the report text, the
figures, the subset selection and the multitrial resume key. Everything
here is numpy on the host, so results must be equal (floats to 1e-12)."""

import dataclasses
import sys
import warnings

import numpy as np
import pytest

from vit2spn_tpu.core import config as jcfg
from vit2spn_tpu.core import presets as jpresets
from vit2spn_tpu.data import native as jnative
from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.evals import kfold as jkfold
from vit2spn_tpu.evals import metrics as jmetrics
from vit2spn_tpu.evals import plots as jplots
from vit2spn_tpu.evals import protocol as jprotocol
from vit2spn_tpu.train import optim as joptim
from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.core import presets as tpresets
from vit2spn_tpu_torch.data.datasets import synthetic_dataset
from vit2spn_tpu_torch.evals import kfold, metrics, plots, protocol
from vit2spn_tpu_torch.train import optim


def port_cfg(jc):
    """A JAX config rebuilt field for field as the port's."""
    if not dataclasses.is_dataclass(jc):
        return jc
    cls = getattr(tcfg, type(jc).__name__)
    return cls(**{f.name: port_cfg(getattr(jc, f.name)) for f in dataclasses.fields(jc)})


# ---------------------------------------------------------------------------
# train/optim.py
# ---------------------------------------------------------------------------

PLATEAU_CASES = {
    # (factor, patience, threshold_mode, metrics)
    "steady-improvement": (0.1, 3, "rel", [1.0, 0.9, 0.8, 0.7, 0.6]),
    "drop-on-patience-plus-one": (0.1, 2, "rel", [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]),
    "sub-threshold-gains-are-bad": (0.5, 1, "rel", [1.0, 0.99995, 0.9999, 0.99985, 0.5]),
    "abs-mode": (0.1, 0, "abs", [1.0, 0.99995, 0.5, 0.49999, 0.4]),
    "recover-then-stall": (0.1, 1, "rel", [2.0, 3.0, 1.0, 1.5, 1.6, 1.7, 0.5, 0.6]),
}


@pytest.mark.parametrize("case", sorted(PLATEAU_CASES))
def test_plateau_matches_jax(case):
    factor, patience, mode, seq = PLATEAU_CASES[case]
    j = joptim.ReduceLROnPlateau(factor=factor, patience=patience, threshold_mode=mode)
    t = optim.ReduceLROnPlateau(factor=factor, patience=patience, threshold_mode=mode)
    for m in seq:
        assert t.step(m) == j.step(m)
        assert (t.best, t.num_bad, t.scale) == (j.best, j.num_bad, j.scale)


STOP_CASES = {
    "never": (3, [5.0, 4.0, 3.0, 2.0]),
    "stop-after-patience": (2, [1.0, 2.0, 3.0]),
    "tie-is-not-better": (2, [1.0, 1.0, 0.5, 0.5, 0.5]),
    "patience-one": (1, [3.0, 2.0, 2.5]),
}


@pytest.mark.parametrize("case", sorted(STOP_CASES))
def test_early_stopping_matches_jax(case):
    patience, seq = STOP_CASES[case]
    j, t = joptim.EarlyStopping(patience=patience), optim.EarlyStopping(patience=patience)
    for i, m in enumerate(seq):
        assert t.step(m, f"state{i}") == j.step(m, f"state{i}")
        assert (t.best, t.counter, t.best_state, t.should_stop) == \
            (j.best, j.counter, j.best_state, j.should_stop)


LABEL_SETS = {
    "balanced": (np.repeat(np.arange(4), 5), 4),
    "skewed": (np.array([0] * 20 + [1] * 3 + [2] * 7 + [3]), 4),
    "class-absent": (np.array([0, 0, 2, 2, 2, 3]), 4),
    "one-class": (np.zeros(7, np.int64), 3),
    "out-of-range-label": (np.array([0, 1, 1, 5]), 3),
}


@pytest.mark.parametrize("case", sorted(LABEL_SETS))
def test_bincount_and_class_weights_match_jax(case):
    """The port counts with numpy; the JAX package through its native
    library (which counts in-range labels only)."""
    labels, k = LABEL_SETS[case]
    assert jnative.available()
    got, ref = optim.balanced_class_weights(labels, k), joptim.balanced_class_weights(labels, k)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# evals/kfold.py
# ---------------------------------------------------------------------------

def _labels(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    return {
        "uniform": rng.integers(0, 4, 103),
        "skewed": np.repeat([0, 1, 2, 3], [60, 25, 11, 4]),
        "small-classes": np.repeat([0, 1, 2, 3], [5, 6, 5, 5]),  # < 10 folds each
        "strings-of-one": np.arange(12) % 3,
    }[kind]


@pytest.mark.parametrize("kind,k,seed", [
    ("uniform", 5, 42), ("uniform", 10, 7), ("skewed", 3, 42),
    ("small-classes", 10, 42), ("strings-of-one", 4, 0),
])
def test_stratified_kfold_matches_jax(kind, k, seed):
    labels = _labels(kind)
    warn = np.bincount(labels).min() < k
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = list(kfold.stratified_kfold(labels, k, seed=seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = list(jkfold.stratified_kfold(labels, k, seed=seed))
    assert any("least populated class" in str(w.message) for w in got_w) == warn
    assert len(got) == len(ref) == k
    for (tr, va), (jtr, jva) in zip(got, ref):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
        assert len(va) > 0  # no fold is ever empty
    with pytest.raises(ValueError, match="n_splits"):
        next(kfold.stratified_kfold(labels[:3], 4))


@pytest.mark.parametrize("fractions", [(0.7, 0.2, 0.1), (0.5, 0.5)])
def test_stratified_holdout_matches_jax(fractions):
    labels = _labels("skewed")
    got = kfold.stratified_holdout(labels, fractions, seed=42)
    ref = jkfold.stratified_holdout(labels, fractions, seed=42)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# evals/metrics.py
# ---------------------------------------------------------------------------

def _scores(case: str):
    rng = np.random.default_rng(11)
    n, k = 60, 4
    labels = rng.integers(0, k, n)
    logits = rng.standard_normal((n, k)) + 1.5 * np.eye(k)[labels]
    if case == "ties":  # coarse scores: many equal thresholds
        logits = np.round(logits)
    if case == "class-absent":  # class 3 never in the labels: NaN AUC
        labels = labels % 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return labels, probs.astype(np.float32)


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("case", ["plain", "ties", "class-absent"])
def test_metrics_match_jax(case):
    labels, probs = _scores(case)
    for c in range(probs.shape[1]):
        _assert_tree_equal(metrics.roc_curve(labels == c, probs[:, c]),
                           jmetrics.roc_curve(labels == c, probs[:, c]))
    _assert_tree_equal(metrics.per_class_roc(labels, probs),
                       jmetrics.per_class_roc(labels, probs))
    got, ref = metrics.mean_auc(labels, probs), jmetrics.mean_auc(labels, probs)
    assert np.isnan(got) == (case == "class-absent")
    _assert_tree_equal(got, ref)
    preds = probs.argmax(1)
    cm = metrics.confusion_matrix(labels, preds, 4)
    np.testing.assert_array_equal(cm, jmetrics.confusion_matrix(labels, preds, 4))
    _assert_tree_equal(metrics.sensitivity_specificity(cm), jmetrics.sensitivity_specificity(cm))
    names = ["cnv", "dme", "drusen", "normal"]
    s, js = metrics.classification_summary(labels, probs, names), \
        jmetrics.classification_summary(labels, probs, names)
    _assert_tree_equal(s, js)
    for digits in (2, 4):
        assert metrics.classification_report_text(s, digits) == \
            jmetrics.classification_report_text(js, digits)


def test_auc_matches_jax():
    x = np.linspace(0, 1, 17) ** 2
    y = np.sqrt(x)
    assert metrics.auc(x, y) == jmetrics.auc(x, y)


# ---------------------------------------------------------------------------
# evals/plots.py
# ---------------------------------------------------------------------------

def test_plots_write_the_jax_figures(tmp_path, monkeypatch):
    """Every figure is a PNG drawn with PIL, on a host without matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    labels, probs = _scores("plain")
    rocs = {f: metrics.per_class_roc(labels, probs) for f in range(2)}
    cm = metrics.confusion_matrix(labels, probs.argmax(1), 4)
    outs = [
        plots.roc_all_folds(rocs, [0.8, 0.9], str(tmp_path / "roc.png"), class_index=1),
        plots.confusion_matrix_plot(cm, list("abcd"), str(tmp_path / "cm.png")),
        plots.loss_curve([1.0, 0.5, 0.25], str(tmp_path / "loss.png")),
        plots.radar_chart(None, str(tmp_path / "radar.png")),
        plots.radar_chart(plots.SSP_SP_RESULTS, str(tmp_path / "radar_ssp.png")),
    ]
    for path in outs:
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", path
    assert plots.PT_SCRATCH_RESULTS == jplots.PT_SCRATCH_RESULTS
    assert plots.SSP_SP_RESULTS == jplots.SSP_SP_RESULTS
    assert plots.RADAR_METRICS == jplots.RADAR_METRICS


# ---------------------------------------------------------------------------
# evals/protocol.py: subsets, the multitrial key, the aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("holdout", [False, True], ids=["fraction", "holdout"])
def test_select_subsets_match_jax(holdout):
    jc = dataclasses.replace(jpresets.get_preset("ft-octmnist"), data=jcfg.DataConfig(
        name="synthetic", subset_fraction=None if holdout else 0.3,
        subset_size=70 if holdout else None, test_subset_size=None if holdout else 20))
    sizes = {"all": 90} if holdout else {"train": 90, "test": 40}
    jds, ds = jax_synthetic(split_sizes=sizes, seed=2), synthetic_dataset(split_sizes=sizes, seed=2)
    for seed in (None, 5):
        got = protocol.select_subsets(port_cfg(jc), ds, seed=seed)
        ref = jprotocol.select_subsets(jc, jds, seed=seed)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.name == b.name


@pytest.mark.parametrize("preset", ["ft-octmnist", "multitrial/ft-octmnist",
                                    "multitrial/ft-ucsdoct", "sl-ssp/sl-octid"])
def test_trial_state_key_matches_jax(preset):
    jc = jpresets.get_preset(preset)
    tc = tpresets.get_preset(preset)
    for epochs in (None, 3):
        assert protocol._trial_state_key(tc, epochs) == jprotocol._trial_state_key(jc, epochs)
    # a state file written by either package resumes in the other
    assert protocol._trial_state_key(dataclasses.replace(tc, seed=1), None) != \
        jprotocol._trial_state_key(jc, None)


def test_multitrial_aggregate_matches_jax():
    fold_metrics = [dict(accuracy=0.5 + 0.1 * i, sensitivity=0.4, specificity=0.8 - 0.05 * i,
                         confidence=0.6) for i in range(3)]
    aucs = [0.7, 0.8, 0.75]
    got = protocol.CVResult(aucs, 1, 0.8, {}, fold_test_metrics=fold_metrics)
    ref = jprotocol.CVResult(aucs, 1, 0.8, {}, fold_test_metrics=fold_metrics)
    assert got.multitrial_aggregate() == ref.multitrial_aggregate()
    assert (got.mean_auc, got.std_auc) == (ref.mean_auc, ref.std_auc)
    with pytest.raises(ValueError, match="per_fold_test"):
        protocol.CVResult(aucs, 1, 0.8, {}).multitrial_aggregate()
