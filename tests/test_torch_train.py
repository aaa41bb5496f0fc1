"""The training slice end to end on the CPU: the port's `SSPTrainer`
(train_step, fit, checkpoints) and `run` CLI against the JAX package's, on
the same data and carried weights, fp32.

Augmentation is off and proj_dropout is 0 for the comparisons: the two
packages draw different random bits by design (core/rng.py). Tolerances are
those of test_training_trajectory_matches_torch_reference: losses within
3e-5, parameters within 2e-5 (float32 reassociation over a few Adam steps,
whose first updates are +-lr wherever a gradient is nonzero)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.models.ssp import ema_update as jax_ema_update
from vit2spn_tpu.models.ssp import negative_cosine_loss as jax_nc_loss
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch.cli import main as port_main
from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.data import native
from vit2spn_tpu_torch.data.datasets import synthetic_dataset
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.models.ssp import (
    backbone_slice,
    ema_update,
    negative_cosine_loss,
    weighted_ssp_loss,
)
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

LOSS_TOL = 3e-5
PARAM_TOL = 2e-5
QUIET = MetricLogger(echo=False)


def _port_cfg(jax_cfg):
    """The JAX config, rebuilt field for field as the port's."""
    d = dataclasses.asdict(jax_cfg)
    return tcfg.SSPConfig(
        vit=tcfg.ViTConfig(**d.pop("vit")),
        data=tcfg.DataConfig(**{**d["data"], "augment": tcfg.AugmentConfig(
            **d["data"]["augment"])}),
        mesh=tcfg.MeshConfig(**d.pop("mesh")),
        **{k: v for k, v in d.items() if k != "data"},
    )


def _no_rand(cfg, **kw):
    """Augmentation and dropout off, so both packages see the same views."""
    return dataclasses.replace(
        cfg, proj_dropout=0.0, **kw,
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, enabled=False)))


def _pair(jcfg):
    """A JAX trainer (random init) and a port trainer carrying its state."""
    jt = JaxSSPTrainer(jcfg, logger=JaxLogger(echo=False))
    pt = SSPTrainer(_port_cfg(jcfg), logger=QUIET, device="cpu")
    pt.state = pt.state._replace(params=from_jax(jax.device_get(jt.state.params),
                                                 device="cpu"))
    return jt, pt


def _assert_params_close(jt, pt, tol=PARAM_TOL):
    ref = jax.tree_util.tree_flatten_with_path(jax.device_get(jt.state.params))[0]
    got = ckpt._flatten(pt.state.params)
    assert len(ref) == len(got)
    for path, leaf in ref:
        key = jckpt._path_key(path)
        np.testing.assert_allclose(got[key], np.asarray(leaf), atol=tol, rtol=0,
                                   err_msg=key)


def test_loss_and_ema_match_jax():
    rng = np.random.default_rng(0)
    pred, tgt = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    pred[2] = 0.0  # the eps clamp of a zero vector
    ref = float(jax_nc_loss(pred, tgt))
    got = negative_cosine_loss(torch.from_numpy(pred), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), ref, atol=1e-7)
    w = torch.ones(6)
    loss, pred_std = weighted_ssp_loss(torch.from_numpy(pred), torch.from_numpy(tgt), w)
    np.testing.assert_allclose(float(loss), ref, atol=1e-7)
    assert loss.requires_grad is False and float(pred_std) > 0
    # weight 0 drops a sample from the mean
    w[5] = 0.0
    masked, _ = weighted_ssp_loss(torch.from_numpy(pred), torch.from_numpy(tgt), w)
    np.testing.assert_allclose(float(masked), float(jax_nc_loss(pred[:5], tgt[:5])),
                               atol=1e-7)

    target = {"a": rng.standard_normal((2, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(4).astype(np.float32)}}
    online = {"a": rng.standard_normal((2, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(4).astype(np.float32)}}
    ref = jax_ema_update(target, online, 0.99)
    t = {"a": torch.from_numpy(target["a"].copy()),
         "b": {"c": torch.from_numpy(target["b"]["c"].copy())}}
    same = ema_update(t, {"a": torch.from_numpy(online["a"]),
                          "b": {"c": torch.from_numpy(online["b"]["c"])}}, 0.99)
    assert same is t  # in place
    np.testing.assert_allclose(t["a"].numpy(), np.asarray(ref["a"]), atol=1e-7)
    np.testing.assert_allclose(t["b"]["c"].numpy(), np.asarray(ref["b"]["c"]), atol=1e-7)


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
def test_training_trajectory_matches_jax(tiny_ssp, dual):
    """3 optimizer steps (2 microbatches of 8 each, Adam, EMA) of the port
    against the JAX SSPTrainer from the same weights on the same batches."""
    jt, pt = _pair(_no_rand(tiny_ssp, dual_stream=dual))
    ds = jax_synthetic(image_size=28, split_sizes={"train": 48}, seed=5)
    eff = tiny_ssp.effective_batch
    for s in range(3):
        batch = ds.images[s * eff:(s + 1) * eff]
        ref = float(jt.train_step(batch, jax.random.key(s))["loss"])
        got = float(pt.train_step(batch, (0, s))["loss"])
        np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0, err_msg=f"step {s}")
    assert int(pt.state.step) == 3
    _assert_params_close(jt, pt)
    np.testing.assert_allclose(
        ckpt._flatten(pt.state)["opt_state/0/mu/0/blocks/w1"],
        np.asarray(jax.device_get(jt.state.opt_state[0].mu[0]["blocks"]["w1"])),
        atol=1e-7)


@pytest.mark.parametrize("impl", ["pallas", "fused_layer"])
def test_backbone_paths_train_like_jax(tiny_ssp, impl):
    """2 optimizer steps through the port's other backbone paths against the
    JAX trainer on the same batches: "pallas" against the JAX "pallas" path
    with its flash kernels in interpret mode ("pallas_interpret");
    "fused_layer" against the JAX trainer's default CPU path (attn_impl=None),
    as the "fused" test above holds "fused", because the JAX "fused_layer"
    calls its kernel without interpret mode."""
    jcfg = _no_rand(tiny_ssp)
    jt = JaxSSPTrainer(jcfg, logger=JaxLogger(echo=False),
                       attn_impl="pallas_interpret" if impl == "pallas" else None)
    pt = SSPTrainer(_port_cfg(jcfg), logger=QUIET, device="cpu", attn_impl=impl)
    pt.state = pt.state._replace(params=from_jax(jax.device_get(jt.state.params),
                                                 device="cpu"))
    ds = jax_synthetic(image_size=28, split_sizes={"train": 32}, seed=6)
    eff = tiny_ssp.effective_batch
    for s in range(2):
        batch = ds.images[s * eff:(s + 1) * eff]
        ref = float(jt.train_step(batch, jax.random.key(s))["loss"])
        got = float(pt.train_step(batch, (0, s))["loss"])
        np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0, err_msg=f"step {s}")
    _assert_params_close(jt, pt)


def test_fused_layer_trains_as_fused(tiny_ssp):
    """On the CPU the per-layer path runs the whole-backbone path's twins
    layer by layer: two steps give the same bits."""
    cfg = _port_cfg(_no_rand(tiny_ssp))
    ds = synthetic_dataset(image_size=28, split_sizes={"train": 32}, seed=7)
    runs = []
    for impl in ("fused", "fused_layer"):
        pt = SSPTrainer(cfg, logger=QUIET, device="cpu", attn_impl=impl)
        losses = [float(pt.train_step(ds.images[s * 16:(s + 1) * 16], (0, s))["loss"])
                  for s in range(2)]
        runs.append((losses, ckpt._flatten(pt.state)))
    (la, sa), (lb, sb) = runs
    assert la == lb
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)


def test_unknown_attn_impl_raises_at_construction(tiny_ssp):
    with pytest.raises(ValueError, match="attn_impl"):
        SSPTrainer(_port_cfg(tiny_ssp), logger=QUIET, device="cpu",
                   attn_impl="pallas_interpret")


def test_masked_tail_epoch_matches_jax_fit(tiny_ssp, tmp_path):
    """One fit epoch over 35 images at effective batch 16: two full steps
    and a tail step with 3 real samples and 13 of weight 0, in the native
    shuffle's order. Same epoch loss, same params, as the JAX fit."""
    cfg = _no_rand(tiny_ssp)
    jt, pt = _pair(cfg)
    assert native.available()
    jds = jax_synthetic(image_size=28, split_sizes={"train": 35}, seed=2)
    ds = synthetic_dataset(image_size=28, split_sizes={"train": 35}, seed=2)
    np.testing.assert_array_equal(ds.images, jds.images)
    jlog, plog = tmp_path / "j.jsonl", tmp_path / "p.jsonl"
    with JaxLogger(str(jlog), echo=False) as lg:
        jt.logger = lg
        ref = jt.fit(jds, epochs=1)
    with MetricLogger(str(plog), echo=False) as lg:
        pt.logger = lg
        got = pt.fit(ds, epochs=1)
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    _assert_params_close(jt, pt)
    ep = [json.loads(l) for l in open(plog) if '"ssp_epoch"' in l][0]
    assert round(ep["images_per_sec"] * ep["seconds"]) == 35


def test_checkpoints_move_both_ways_with_adam_state(tiny_ssp, tmp_path):
    """A JAX training checkpoint taken after one step (Adam moments
    nonzero) restores into the port, and one more step matches the JAX
    trainer's; the port's checkpoint restores into JAX `checkpoint.restore`
    strictly, moments included."""
    cfg = _no_rand(tiny_ssp)
    jt = JaxSSPTrainer(cfg, logger=JaxLogger(echo=False))
    ds = jax_synthetic(image_size=28, split_sizes={"train": 32}, seed=3)
    jt.train_step(ds.images[:16], jax.random.key(0))
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jax.device_get(jt.state), {"epoch": 1})
    pt = SSPTrainer(_port_cfg(cfg), logger=QUIET, device="cpu")
    pt.restore(path)
    assert int(pt.state.step) == 1 and int(pt.state.opt_state[0]["count"]) == 1
    ref = float(jt.train_step(ds.images[16:], jax.random.key(1))["loss"])
    got = float(pt.train_step(ds.images[16:], (0, 1))["loss"])
    np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0)
    _assert_params_close(jt, pt)

    back = str(tmp_path / "port.npz")
    ckpt.save(back, pt.state, {"epoch": 2})
    restored = jckpt.restore(back, jax.device_get(jt.state), strict=True)
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(restored.opt_state)[0],
            jax.tree_util.tree_flatten_with_path(jax.device_get(jt.state.opt_state))[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   err_msg=jckpt._path_key(p))


def test_fit_resumes_where_the_checkpoint_left_off(tiny_ssp, tmp_path):
    """Augmentation and dropout on: two epochs in one `fit` against one epoch,
    a checkpoint, and a fresh trainer resuming to two. Every random stream is
    keyed by (seed, epoch, step), the epoch order by seed + epoch and the
    Adam state is in the checkpoint, so both reach the same bits. The
    checkpoint's lineage wins over the resuming trainer's own."""
    cfg = dataclasses.replace(_port_cfg(tiny_ssp), checkpoint_every_epochs=1)
    assert cfg.proj_dropout > 0 and cfg.data.augment.enabled
    # 40 images at effective batch 16: two steps and a masked tail an epoch
    ds = synthetic_dataset(image_size=28, split_sizes={"train": 40}, seed=4)
    straight = SSPTrainer(cfg, logger=QUIET, device="cpu")
    ref = straight.fit(ds, epochs=2)
    path = str(tmp_path / "checkpoint.npz")
    first = SSPTrainer(cfg, logger=QUIET, device="cpu")
    assert first.fit(ds, epochs=1, checkpoint_path=path) == ref[:1]
    assert ckpt.metadata(path)["epoch"] == 1
    resumed = SSPTrainer(cfg, backbone_params=backbone_slice(first.params.online, 1),
                         logger=QUIET, device="cpu")
    assert resumed.init_provenance == "explicit"
    assert resumed.fit(ds, epochs=2, checkpoint_path=path) == ref[1:]
    assert resumed.fit_resume_epoch == 1 and resumed.fit_resume_loss == ref[0]
    assert resumed.init_provenance == "random"
    assert int(resumed.state.step) == int(straight.state.step) == 6
    got, want = ckpt._flatten(resumed.state), ckpt._flatten(straight.state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


TINY = ["data.name=synthetic", "vit.image_size=32", "vit.hidden_size=32",
        "vit.num_layers=2", "vit.num_heads=2", "vit.mlp_dim=64",
        "data.augment.out_size=32", "compute_dtype=float32", "batch_size=8",
        "accumulation_steps=2", "checkpoint_every_epochs=1"]


def test_run_cli_trains_and_exports(tmp_path, monkeypatch):
    """`run ssp-scratch --device cpu` with tiny overrides trains on the
    synthetic stand-in (the augmentation stack on), checkpoints, exports the
    stream-1 backbone, and logs; the export loads into the JAX package."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "run"
    argv = ["run", "ssp-scratch", "--device", "cpu", "--epochs", "1",
            "--output-dir", str(out)]
    for o in TINY:
        argv += ["-o", o]
    assert port_main(argv) == 0
    export = out / "octmnist_vit2spn_tiny_scratch_model.npz"
    assert (out / "checkpoint.npz").exists() and export.exists()
    meta = ckpt.metadata(str(out / "checkpoint.npz"))
    assert meta["epoch"] == 1 and meta["dataset_synthetic"] is True
    assert meta["init_provenance"] == "random"
    events = [json.loads(l)["event"] for l in open(out / "metrics.jsonl")]
    assert "ssp_epoch" in events and "export" in events
    assert jckpt.metadata(str(export))["format"] == "vit_backbone"
    assert (out / "ssp_loss_curve.png").exists()  # the scratch variant's plot
    # fine-tune presets run (tests/test_torch_finetune.py), the folder
    # datasets' too: here ft-octid on the OCTID loader's synthetic stand-in
    ft = tmp_path / "ft"
    argv = ["run", "ft-octid", "--device", "cpu", "--epochs", "1", "--output-dir", str(ft),
            "-o", "init=random", "-o", "k_folds=2", "-o", "data.subset_size=40",
            "-o", f"data.root={tmp_path / 'no_folders'}"]
    for o in TINY[1:-2]:
        argv += ["-o", o]
    assert port_main(argv) == 0
    assert (ft / "octid_cv_result.json").exists()


def test_run_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    """Without --device the run is on CUDA; with no CUDA it raises rather
    than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["run", "ssp-scratch", "--epochs", "1", "--output-dir", str(tmp_path)]
    for o in TINY:
        argv += ["-o", o]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(argv)
    assert not os.path.exists(tmp_path / "checkpoint.npz")
