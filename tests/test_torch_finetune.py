"""The fine-tune slice on the CPU: the port's classifier head, loss,
`FineTuneTrainer` (train epochs, evaluate, fit), CV and multitrial protocols
and `run <ft preset>` against the JAX package's, on the same data and one
carried state, fp32.

Augmentation is off, head dropout 0 and `eval_augment=False` for the
comparisons: the two packages draw different random bits by design
(core/rng.py). The JAX trainer runs its XLA path; the port's runs "fused",
whose kernels' plain twins run on the CPU. Tolerances are those of the JAX
package's own torch drill (test_finetune_trajectory_matches_torch_reference):
epoch losses 3e-5, eval probabilities 2e-5, val loss 3e-5, parameters and
BN running statistics 5e-4 (Adam turns sub-eps gradient differences into
lr-sized steps); the inert leaves leave training bit-equal to their start."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from vit2spn_tpu.cli import _save_cv_result as jax_save_cv_result
from vit2spn_tpu.core import rng as jrng
from vit2spn_tpu.core.config import AugmentConfig, DataConfig
from vit2spn_tpu.data.datasets import Dataset as JaxDataset
from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.evals import protocol as jprotocol
from vit2spn_tpu.models.heads import classifier_head_apply as jax_head_apply
from vit2spn_tpu.models.heads import init_classifier_head as jax_init_head
from vit2spn_tpu.models.vit import init_vit as jax_init_vit
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.finetune import FineTuneTrainer as JaxFineTuneTrainer
from vit2spn_tpu.train.finetune import weighted_cross_entropy as jax_wce
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch import cli
from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.data.datasets import Dataset, synthetic_dataset
from vit2spn_tpu_torch.evals import protocol
from vit2spn_tpu_torch.models.convert import finetune_from_jax, finetune_to_jax, from_jax
from vit2spn_tpu_torch.models.heads import classifier_head_apply, init_bn_state
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.finetune import FineTuneTrainer, weighted_cross_entropy
from vit2spn_tpu_torch.train.ssp import _copy
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

LOSS_TOL = 3e-5
PROB_TOL = 2e-5
PARAM_TOL = 5e-4
NUM_CLASSES = 3


def port_cfg(jc):
    """A JAX config rebuilt field for field as the port's."""
    if not dataclasses.is_dataclass(jc):
        return jc
    cls = getattr(tcfg, type(jc).__name__)
    return cls(**{f.name: port_cfg(getattr(jc, f.name)) for f in dataclasses.fields(jc)})


@pytest.fixture(scope="module")
def jcfg(tiny_ft):
    """The tiny fine-tune config with every random part off (one config for
    the whole module, so the JAX trainer compiles once)."""
    return dataclasses.replace(
        tiny_ft, head_hidden=16, head_dropout=0.0,
        data=DataConfig(name="synthetic", augment=AugmentConfig(out_size=32, enabled=False)))


def _datasets(n, seed):
    """The same images and labels as a JAX and a port Dataset."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, 32, 1), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int64)
    kw = dict(name=f"d{seed}", images=images, labels=labels, num_classes=NUM_CLASSES,
              class_names=[str(c) for c in range(NUM_CLASSES)])
    return JaxDataset(**kw), Dataset(**kw)


def _pair(jcfg, **kw):
    """A JAX trainer and a port trainer carrying its state."""
    jt = JaxFineTuneTrainer(jcfg, NUM_CLASSES, logger=JaxLogger(echo=False),
                            eval_augment=False, **kw)
    pt = FineTuneTrainer(port_cfg(jcfg), NUM_CLASSES, logger=MetricLogger(echo=False),
                         eval_augment=False, device="cpu", **kw)
    pt.state = finetune_from_jax(jax.device_get(jt.state), device="cpu")
    return jt, pt


def _jax_flat(state) -> dict:
    return {jckpt._path_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}


def _assert_states_close(jt, pt, tol=PARAM_TOL):
    ref, got = _jax_flat(jt.state), ckpt._flatten(pt.state)
    assert got.keys() == ref.keys()
    for k in ref:
        if k.startswith(("backbone/", "head/", "bn_state/")):
            np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=0, err_msg=k)
    assert int(got["opt_state/1/count"]) == int(ref["opt_state/1/count"])


INERT = ("backbone/pooler/", "backbone/final_ln/")


# ---------------------------------------------------------------------------
# the head, the loss, the state carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_classifier_head_matches_jax(train):
    """Linear, BN (batch statistics and the running-stat update in train
    mode; running statistics in eval), ReLU, Linear, fp32."""
    rng = np.random.default_rng(0)
    head = jax.device_get(jax_init_head(jax.random.key(1), 12, 16, 5))
    head["bn"] = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                  "bias": rng.normal(0, 0.1, 16).astype(np.float32)}
    bn = {"mean": rng.normal(0, 0.2, 16).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, 16).astype(np.float32),
          "count": np.asarray(3, np.int32)}
    x = rng.standard_normal((9, 12)).astype(np.float32)
    ref_logits, ref_bn = jax_head_apply(head, bn, x, dropout_rate=0.0, train=train)
    logits, new_bn = classifier_head_apply(from_jax(head, device="cpu"),
                                           from_jax(bn, device="cpu"),
                                           torch.from_numpy(x), dropout_rate=0.0,
                                           train=train)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-6, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_bn[k].numpy(), np.asarray(ref_bn[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
        assert not new_bn[k].requires_grad
    assert new_bn["count"].dtype == torch.int32
    assert int(new_bn["count"]) == int(ref_bn["count"]) == 3 + train
    fresh = init_bn_state(16, device="cpu")
    assert float(fresh["var"].min()) == 1.0 and int(fresh["count"]) == 0


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((10, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 10)
    for w in (np.array([1.0, 2.0, 0.5, 0.0], np.float32), np.zeros(4, np.float32)):
        ref = float(jax_wce(logits, labels, w))
        got = float(weighted_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), torch.from_numpy(w)))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_state_carries_both_ways(jcfg):
    """JAX state -> port trainer -> back: every leaf equal, under the same
    checkpoint names; a port checkpoint restores strictly in the JAX
    package."""
    jt, pt = _pair(jcfg)
    ref = _jax_flat(jt.state)
    got = ckpt._flatten(pt.state)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    back = jax.tree.unflatten(jax.tree.structure(jax.device_get(jt.state)),
                              jax.tree.leaves(finetune_to_jax(pt.state)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.device_get(jt.state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_trajectory_matches_jax(jcfg):
    """Two epochs over the same index matrices (non-uniform class weights),
    then evaluate on a val set whose last batch is padded: losses, probs,
    params, BN statistics; the inert leaves bit-equal to their start."""
    jt, pt = _pair(jcfg)
    start = {k: v.copy() for k, v in ckpt._flatten(pt.state).items()}  # not views
    jtrain, ptrain = _datasets(48, 1)
    jval, pval = _datasets(13, 2)
    w = np.array([1.0, 2.0, 0.5], np.float32)
    images, labels = jt._device_data(jtrain)
    rng = np.random.default_rng(3)
    for epoch in range(2):
        idx_mat = rng.permutation(48).reshape(-1, jcfg.batch_size)
        jt.state, ref = jt._train_epoch(jt.state, images, labels,
                                        jax.numpy.asarray(idx_mat, jax.numpy.int32),
                                        jax.numpy.asarray(w), jax.random.key(epoch),
                                        jax.numpy.asarray(1.0, jax.numpy.float32))
        got = pt.train_epoch(ptrain, idx_mat, w, epoch)
        np.testing.assert_allclose(float(got), float(ref), atol=LOSS_TOL, rtol=0,
                                   err_msg=f"epoch {epoch}")
    ref_loss, ref_probs, ref_labels = jt.evaluate(jval, w)
    loss, probs, labels_out = pt.evaluate(pval, w)
    assert probs.shape == (13, NUM_CLASSES)
    np.testing.assert_array_equal(labels_out, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(loss, ref_loss, atol=LOSS_TOL, rtol=0)
    _assert_states_close(jt, pt)
    end, jend = ckpt._flatten(pt.state), _jax_flat(jt.state)
    inert = [k for k in start if k.startswith(INERT)]
    assert len(inert) == 4
    for k in inert:
        np.testing.assert_array_equal(end[k], start[k], err_msg=k)
        np.testing.assert_array_equal(jend[k], start[k], err_msg=k)
    assert int(end["opt_state/1/count"]) == 12 and int(end["bn_state/count"]) == 12


@pytest.mark.parametrize("restore", [False, True], ids=["final-weights", "restore-best"])
def test_fit_matches_jax_fit(jcfg, restore):
    """`fit` with the scheduler and early stop on, over the same data, both
    sides given one scripted val-loss sequence: the same epochs, lr scales,
    train losses, restore outcome and final state."""
    cfg = dataclasses.replace(jcfg, epochs=7, plateau_patience=1, early_stop_patience=3,
                              restore_best_weights=restore)
    jt, pt = _pair(cfg)
    jtrain, ptrain = _datasets(40, 4)
    w = np.array([1.0, 1.5, 0.7], np.float32)
    # best at epoch 2; the plateau drops the lr after epoch 4; the stop
    # comes after epoch 5
    script = [1.0, 0.5, 0.9, 0.95, 0.97, 0.99, 0.98]
    logs = []
    for tr, ds, lg in ((jt, jtrain, JaxLogger), (pt, ptrain, MetricLogger)):
        events = []
        tr.logger = type("Capture", (lg,), {"log": lambda self, e, **kw: events.append((e, kw))})(
            echo=False)
        vals = iter(script)
        tr.evaluate = lambda val_ds, cw, seed=0, vals=vals: (next(vals), None, None)
        assert tr.fit(ds, ds, w, tag="fold0") == 0.5
        logs.append(events)
    jlog, plog = logs
    assert [e for e, _ in plog] == [e for e, _ in jlog]
    epochs = [kw for e, kw in plog if e == "fold0_epoch"]
    jepochs = [kw for e, kw in jlog if e == "fold0_epoch"]
    assert len(epochs) == 5
    assert [kw["lr_scale"] for kw in epochs] == [kw["lr_scale"] for kw in jepochs] == \
        [1.0, 1.0, 1.0, 0.1, 0.1]
    for got, ref in zip(epochs, jepochs):
        assert got.keys() == ref.keys()
        np.testing.assert_allclose(got["train_loss"], ref["train_loss"], atol=LOSS_TOL, rtol=0)
        assert got["val_loss"] == ref["val_loss"]
    restores = [kw for e, kw in plog if e == "fold0_best_restore"]
    assert restores == [kw for e, kw in jlog if e == "fold0_best_restore"]
    assert restores == ([{"best_val_loss": 0.5}] if restore else [])
    _assert_states_close(jt, pt)
    if restore:  # the state as of epoch 2: 2 epochs x 5 steps
        assert int(ckpt._flatten(pt.state)["opt_state/1/count"]) == 10
    assert all(p.grad is None for p in pt._trainable)


def test_trainer_guards_and_trial_streams(jcfg):
    cfg = port_cfg(jcfg)
    quiet = MetricLogger(echo=False)
    tr = FineTuneTrainer(cfg, NUM_CLASSES, logger=quiet, device="cpu")
    with pytest.raises(ValueError, match="empty dataset"):
        tr.evaluate(_datasets(0, 0)[1], np.ones(NUM_CLASSES, np.float32))
    # one process cannot hold 2 model ranks (tensor parallelism needs a
    # world size it divides): refused as the JAX make_mesh refuses it
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        FineTuneTrainer(tcfg.replace(cfg, **{"mesh.model_parallel": 2}), NUM_CLASSES,
                        device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        FineTuneTrainer(cfg, NUM_CLASSES, attn_impl="pallas_interpret", device="cpu")
    # trial 0 is deterministic; a trial re-draws the init; a given backbone
    # is copied, so training one fold leaves the export untouched
    again = FineTuneTrainer(cfg, NUM_CLASSES, logger=quiet, device="cpu")
    other = FineTuneTrainer(cfg, NUM_CLASSES, logger=quiet, device="cpu", trial=1)
    w = tr.head["linear_0"]["w"]
    assert torch.equal(w, again.head["linear_0"]["w"])
    assert not torch.equal(w, other.head["linear_0"]["w"])
    given = FineTuneTrainer(cfg, NUM_CLASSES, backbone_params=tr.backbone, device="cpu",
                            logger=quiet)
    assert given.backbone["blocks"]["w1"].data_ptr() != tr.backbone["blocks"]["w1"].data_ptr()
    assert torch.equal(given.backbone["blocks"]["w1"], tr.backbone["blocks"]["w1"])


# ---------------------------------------------------------------------------
# the protocols
# ---------------------------------------------------------------------------

def _recording(fn, out):
    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        if isinstance(res, tuple):
            out.append(res)
            return res
        res = list(res)  # the k-fold generator
        out.append(res)
        return iter(res)
    return wrapped


@pytest.fixture
def jax_heads(monkeypatch):
    """Port trainers start from the JAX trainer's init for the same (seed,
    fold, trial): the two packages draw other bits by design."""
    init = FineTuneTrainer.__init__

    def patched(self, cfg, num_classes, backbone_params=None, mesh=None, logger=None, fold=0,
                attn_impl=None, eval_augment=True, trial=0, device=None):
        init(self, cfg, num_classes, backbone_params, mesh, logger, fold, attn_impl,
             eval_augment, trial, device)
        key = jrng.fold(jrng.root_key(cfg.seed), fold)
        if trial:
            key = jrng.fold(key, trial)
        bk, hk = jax.random.split(key)
        head = jax_init_head(hk, cfg.vit.hidden_size, cfg.head_hidden, num_classes)
        _copy(self.head, from_jax(jax.device_get(head), device=self.device))
        if backbone_params is None:
            _copy(self.backbone, from_jax(jax.device_get(jax_init_vit(bk, cfg.vit)),
                                          device=self.device))

    monkeypatch.setattr(FineTuneTrainer, "__init__", patched)


def _protocol_cfg(jcfg, **kw):
    return dataclasses.replace(
        jcfg, k_folds=2, epochs=1, **kw,
        data=dataclasses.replace(jcfg.data, subset_fraction=0.5, test_subset_size=20))


def test_cv_protocol_matches_jax(jcfg, jax_heads, monkeypatch, tmp_path):
    """run_cv_protocol (2 folds, 1 epoch) from one backbone and the JAX
    heads: equal subsets and fold indices, fold mAUCs within 1e-3, the same
    best fold and test confusion matrix; `<ds>_cv_result.json` as the JAX
    CLI writes it."""
    cfg = _protocol_cfg(jcfg)
    sizes = {"train": 64, "test": 30}
    jds, ds = jax_synthetic(split_sizes=sizes, seed=8), synthetic_dataset(split_sizes=sizes,
                                                                          seed=8)
    backbone = jax.device_get(jax_init_vit(jax.random.key(9), cfg.vit))
    seen = {}
    for mod, fns in ((jprotocol, ("select_subsets", "stratified_kfold")),
                     (protocol, ("select_subsets", "stratified_kfold"))):
        for name in fns:
            seen[(mod, name)] = []
            monkeypatch.setattr(mod, name, _recording(getattr(mod, name), seen[(mod, name)]))
    ref = jprotocol.run_cv_protocol(cfg, dataset=jds, backbone_params=backbone,
                                    logger=JaxLogger(echo=False), eval_augment=False)
    got = protocol.run_cv_protocol(port_cfg(cfg), dataset=ds, backbone_params=backbone,
                                   logger=MetricLogger(echo=False), eval_augment=False,
                                   device="cpu")
    (jsub,), (sub,) = seen[(jprotocol, "select_subsets")], seen[(protocol, "select_subsets")]
    for a, b in zip(sub, jsub):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    (jfolds,), (folds,) = seen[(jprotocol, "stratified_kfold")], seen[(protocol, "stratified_kfold")]
    for (tr, va), (jtr, jva) in zip(folds, jfolds):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
    np.testing.assert_allclose(got.fold_aucs, ref.fold_aucs, atol=1e-3, rtol=0)
    assert got.best_fold == ref.best_fold
    np.testing.assert_array_equal(got.test_summary["confusion_matrix"],
                                  ref.test_summary["confusion_matrix"])
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    out_p.mkdir(), out_j.mkdir()
    with open(cli._save_cv_result(got, port_cfg(cfg), str(out_p))) as f:
        pay = json.load(f)
    with open(jax_save_cv_result(ref, cfg, str(out_j))) as f:
        jpay = json.load(f)

    def same_keys(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same_keys(a[k], b[k])

    same_keys(pay, jpay)
    assert pay["best_fold"] == jpay["best_fold"] and pay["class_names"] == jpay["class_names"]


def test_protocol_hands_one_mesh_to_every_fold(jcfg, monkeypatch):
    """run_cv_protocol(cfg, mesh=m) and run_multitrial(cfg, mesh=m) hand m to
    every fold's trainer, as the JAX functions do; without a mesh each call
    makes one for all of its trials and folds, so no fold makes process
    groups of its own."""
    cfg = port_cfg(_protocol_cfg(jcfg, num_trials=2))
    ds = synthetic_dataset(split_sizes={"train": 48, "test": 20}, seed=10)
    quiet = MetricLogger(echo=False)
    seen, made = [], []
    real_trainer, real_make = protocol.FineTuneTrainer, protocol.make_mesh

    def trainer(*a, mesh=None, **kw):
        seen.append(mesh)
        return real_trainer(*a, mesh=mesh, **kw)

    def make(*a, **kw):
        made.append(real_make(*a, **kw))
        return made[-1]

    monkeypatch.setattr(protocol, "FineTuneTrainer", trainer)
    monkeypatch.setattr(protocol, "make_mesh", make)
    m = real_make(cfg.mesh.model_parallel, device="cpu")
    protocol.run_cv_protocol(cfg, dataset=ds, logger=quiet, mesh=m, device="cpu")
    protocol.run_multitrial(cfg, dataset=ds, logger=quiet, mesh=m, device="cpu")
    assert len(seen) == 3 * cfg.k_folds and all(x is m for x in seen) and made == []
    seen.clear()
    protocol.run_multitrial(cfg, dataset=ds, logger=quiet, device="cpu")
    assert len(made) == 1 and len(seen) == 2 * cfg.k_folds
    assert all(x is made[0] for x in seen)


def test_multitrial_resume_equals_an_uninterrupted_run(jcfg, tmp_path, monkeypatch):
    """A multitrial run killed after trial 0 resumes at trial 1 and ends
    with what one uninterrupted run gives, bit for bit; a state file the JAX
    package wrote resumes in the port."""
    cfg = port_cfg(_protocol_cfg(jcfg, num_trials=2))
    ds = synthetic_dataset(split_sizes={"train": 48, "test": 20}, seed=10)
    quiet = MetricLogger(echo=False)
    straight = protocol.run_multitrial(cfg, dataset=ds, logger=quiet, device="cpu")
    assert straight["trials"][0]["fold_aucs"] != straight["trials"][1]["fold_aucs"]
    path = str(tmp_path / "multitrial_state.json")
    run_cv = protocol.run_cv_protocol

    def killed(*a, trial=0, **kw):
        if trial == 1:
            raise KeyboardInterrupt
        return run_cv(*a, trial=trial, **kw)

    monkeypatch.setattr(protocol, "run_cv_protocol", killed)
    with pytest.raises(KeyboardInterrupt):
        protocol.run_multitrial(cfg, dataset=ds, logger=quiet, resume_path=path,
                                device="cpu")
    monkeypatch.setattr(protocol, "run_cv_protocol", run_cv)
    assert len(json.load(open(path))["trials"]) == 1
    events = []
    cap = type("Capture", (MetricLogger,), {"log": lambda self, e, **kw: events.append(e)})(
        echo=False)
    resumed = protocol.run_multitrial(cfg, dataset=ds, logger=cap, resume_path=path,
                                      device="cpu")
    assert "multitrial_resume" in events and events.count("trial") == 1
    assert resumed == straight
    # the JAX package's state file for the same config resumes here
    jpath = str(tmp_path / "jax_state.json")
    jprotocol._save_trial_state(jpath, _protocol_cfg(jcfg, num_trials=2),
                                straight["trials"][:1])
    assert protocol._load_trial_state(jpath, cfg) == straight["trials"][:1]
    assert protocol._load_trial_state(jpath, cfg, epochs=3) == []


# ---------------------------------------------------------------------------
# run <ft preset>
# ---------------------------------------------------------------------------

TINY = ["data.name=synthetic", "vit.image_size=32", "vit.hidden_size=32",
        "vit.num_layers=2", "vit.num_heads=2", "vit.mlp_dim=64",
        "data.augment.out_size=32", "compute_dtype=float32", "batch_size=8"]
FT_TINY = TINY + ["data.subset_fraction=0.02", "data.test_subset_size=24", "k_folds=2",
                  "head_hidden=16"]
CV_KEYS = {"dataset", "class_names", "fold_aucs", "best_fold", "confusion_matrix",
           "fold_rocs"}


def _argv(*head, overrides):
    argv = list(head)
    for o in overrides:
        argv += ["-o", o]
    return argv


@pytest.mark.parametrize("source", ["port-ssp-scratch", "jax-export"])
def test_run_ft_preset_from_an_ssp_export(source, tmp_path, tiny_ssp, capsys):
    """`run ft-octmnist --device cpu` with tiny overrides, initialized from
    the SSP export that the port's `run ssp-scratch` wrote, or from one the
    JAX trainer wrote: the backbone starts as the export's (strictly
    restored), the four artifacts appear under the JAX names, the report is
    printed, metrics.jsonl holds the protocol's events."""
    if source == "port-ssp-scratch":
        assert cli.main(_argv("run", "ssp-scratch", "--device", "cpu", "--epochs", "1",
                              "--output-dir", str(tmp_path / "ssp"),
                              overrides=TINY + ["accumulation_steps=2"])) == 0
        export = tmp_path / "ssp" / "octmnist_vit2spn_tiny_scratch_model.npz"
        assert (tmp_path / "ssp" / "ssp_loss_curve.png").exists()
    else:
        export = tmp_path / "jax_export.npz"
        JaxSSPTrainer(tiny_ssp, logger=JaxLogger(echo=False)).export_backbone(str(export))
    overrides = FT_TINY + ["init=scratch", f"init_path={export}"]
    cfg = cli._apply_overrides(tcfg.FineTuneConfig(), overrides)
    backbone = cli._resolve_backbone(cfg, MetricLogger(echo=False))
    want = ckpt._flatten(ckpt.restore(str(export), backbone))
    for k, v in ckpt._flatten(backbone).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert jckpt.metadata(str(export))["format"] == "vit_backbone"

    out = tmp_path / "ft"
    assert cli.main(_argv("run", "ft-octmnist", "--device", "cpu", "--epochs", "1",
                          "--output-dir", str(out), overrides=overrides)) == 0
    for name in ("roc_curve_all_folds.png", "confusion_matrix.png",
                 "classification_report.txt", "cv_result.json"):
        assert (out / f"synthetic_{name}").exists(), name
    report = (out / "synthetic_classification_report.txt").read_text()
    assert "weighted avg" in report and report in capsys.readouterr().out
    with open(out / "synthetic_cv_result.json") as f:
        payload = json.load(f)
    assert payload.keys() == CV_KEYS and len(payload["fold_aucs"]) == 2
    events = [json.loads(l)["event"] for l in open(out / "metrics.jsonl")]
    for e in ("protocol", "fold0_epoch", "fold_result", "cv_summary"):
        assert e in events, e
    assert "fold_memory" not in events  # a CUDA-only record


def test_resolve_backbone_is_strict_and_falls_back(tmp_path, monkeypatch):
    """A training checkpoint is not a backbone export: it raises. A missing
    export warns and falls back to the pretrained weights, here missing too:
    random."""
    monkeypatch.setenv("VIT2SPN_VIT_TINY_PATH", str(tmp_path / "no_weights.npz"))
    cfg = cli._apply_overrides(tcfg.FineTuneConfig(), FT_TINY + ["init=scratch"])
    trainer_like = {"params": {"w": torch.zeros(2)}, "step": torch.zeros(())}
    ckpt.save(str(tmp_path / "checkpoint.npz"), trainer_like)
    with pytest.raises(KeyError, match="checkpoint mismatch"):
        cli._resolve_backbone(tcfg.replace(cfg, init_path=str(tmp_path / "checkpoint.npz")),
                              MetricLogger(echo=False))
    events = []
    cap = type("Capture", (MetricLogger,), {"log": lambda self, e, **kw: events.append(kw)})(
        echo=False)
    missing = tcfg.replace(cfg, init_path=str(tmp_path / "none.npz"))
    assert cli._resolve_backbone(missing, cap) is None
    assert "not found" in events[0]["message"]
    assert cli._resolve_backbone(tcfg.replace(cfg, init="random"), cap) is None
