"""The serving slice end to end: the port's `SSPTrainer.extract_features`
and `extract` CLI against the JAX package's on the same synthetic dataset
and carried weights, fp32 on the CPU, plus checkpoint interop both ways.

Tolerance: atol 2e-5 on features of magnitude ~0.1-1, from float32
reassociation and the A&S erf (1.5e-7) against jax.nn.gelu's exact erf."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.models.vit import init_vit as jax_init_vit
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch.cli import main as port_main
from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.data.datasets import synthetic_dataset
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

ATOL = 2e-5
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


@pytest.fixture(scope="module", params=[True, False], ids=["dual", "single"])
def trainers(request, tiny_ssp):
    """A JAX trainer (random init) and a port trainer carrying its weights."""
    jcfg = dataclasses.replace(tiny_ssp, dual_stream=request.param)
    jt = JaxSSPTrainer(jcfg, logger=JaxLogger(echo=False))
    pt = SSPTrainer(_port_cfg(jcfg), logger=QUIET, device="cpu")
    pt.state = pt.state._replace(
        params=from_jax(jax.device_get(jt.state.params), device="cpu"))
    return jt, pt


@pytest.fixture(scope="module")
def dataset():
    return synthetic_dataset(image_size=28, split_sizes={"all": 20})


@pytest.mark.parametrize("features", ["pred", "backbone"])
def test_extract_features_matches_jax(trainers, dataset, features):
    jt, pt = trainers
    jds = jax_synthetic(image_size=28, split_sizes={"all": 20})
    ref, ref_labels = jt.extract_features(jds, batch_size=8, features=features)
    got, labels = pt.extract_features(dataset, batch_size=8, features=features)
    n = 2 if pt.cfg.dual_stream else 1
    width = pt.cfg.proj_dim if features == "pred" else n * pt.cfg.vit.hidden_size
    assert got.shape == ref.shape == (20, width) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(labels, ref_labels)


def test_extract_pads_the_last_chunk_like_jax(trainers, dataset):
    """Batch 8 over 20 images pads the last chunk with copies of its first
    image; the features of the real images do not depend on the chunking.
    The augmented views (`augment=True`) are drawn from the seed: the same
    call gives the same features, other than the deterministic views'."""
    _, pt = trainers
    a, _ = pt.extract_features(dataset, batch_size=8)
    b, _ = pt.extract_features(dataset, batch_size=20)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="features"):
        pt.extract_features(dataset, features="logits")
    aug, _ = pt.extract_features(dataset, batch_size=8, augment=True)
    assert aug.shape == a.shape and np.isfinite(aug).all()
    assert np.abs(aug - a).max() > 1e-3
    np.testing.assert_array_equal(
        aug, pt.extract_features(dataset, batch_size=8, augment=True)[0])


def test_jax_checkpoint_restores_into_the_port(tiny_ssp, dataset, tmp_path):
    """JAX `ckpt.save(device_get(trainer.state))` -> port restore -> the
    same features as the JAX trainer (the Adam leaves restore too)."""
    jt = JaxSSPTrainer(dataclasses.replace(tiny_ssp, seed=7),
                       logger=JaxLogger(echo=False))
    path = str(tmp_path / "checkpoint.npz")
    jckpt.save(path, jax.device_get(jt.state), {"epoch": 3})
    pt = SSPTrainer(_port_cfg(tiny_ssp), logger=QUIET, device="cpu")
    before = pt.state.params.online["cls_token"].clone()
    pt.restore(path)
    assert not torch.equal(before, pt.state.params.online["cls_token"])
    jds = jax_synthetic(image_size=28, split_sizes={"all": 20})
    ref, _ = jt.extract_features(jds, batch_size=8)
    got, _ = pt.extract_features(dataset, batch_size=8)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # strict: a checkpoint of another geometry is refused
    other = dataclasses.replace(
        tiny_ssp, vit=dataclasses.replace(tiny_ssp.vit, hidden_size=16))
    pt_other = SSPTrainer(_port_cfg(other), logger=QUIET, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        pt_other.restore(path)


def test_port_export_restores_into_jax(trainers, tmp_path):
    """Port `export_backbone` -> JAX `ckpt.restore(path, init_vit template,
    strict=True)` succeeds and gives the same values."""
    _, pt = trainers
    path = pt.export_backbone(str(tmp_path / "export.npz"))
    template = jax_init_vit(jax.random.key(0), pt.cfg.vit)
    restored = jckpt.restore(path, template, strict=True)
    assert jckpt.metadata(path)["format"] == "vit_backbone"
    flat_j = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(flat_j) == 20  # 12 block leaves + 8 others
    for p, leaf in flat_j:
        key = [getattr(k, "key", k) for k in p]
        ref = pt.state.params.online
        for k in key:
            ref = ref[k]
        # the trainer's params are leaves that require grad (Adam's params)
        np.testing.assert_array_equal(np.asarray(leaf), ref[0].detach().numpy())


def test_port_checkpoint_roundtrip(trainers, tmp_path):
    _, pt = trainers
    path = str(tmp_path / "state.npz")
    ckpt.save(path, pt.state, {"epoch": 1})
    assert ckpt.metadata(path) == {"epoch": 1}
    fresh = SSPTrainer(pt.cfg, logger=QUIET, device="cpu")
    fresh.state = fresh.state._replace(params=fresh.state.params._replace(
        heads=jax.tree_util.tree_map(torch.zeros_like, fresh.state.params.heads)))
    fresh.restore(path)
    for a, b in zip(ckpt._flatten(fresh.state).values(),
                    ckpt._flatten(pt.state).values()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(path, {"not": torch.zeros(1)})
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore(path, {"step": torch.ones((), dtype=torch.int32)})
    only_step = ckpt.restore(path, {"step": torch.ones((), dtype=torch.int32)},
                             ignore=("params/", "opt_state/"))
    assert int(only_step["step"]) == 0


def test_extract_cli_matches_jax_trainer(tiny_ssp, tmp_path, capsys):
    """`python -m vit2spn_tpu_torch extract` on the CPU, from a JAX training
    checkpoint, writes the JAX trainer's features for the chosen split."""
    jt = JaxSSPTrainer(tiny_ssp, logger=JaxLogger(echo=False))
    path = str(tmp_path / "checkpoint.npz")
    jckpt.save(path, jax.device_get(jt.state), {"epoch": 1})
    out = str(tmp_path / "feats.npz")
    overrides = [
        "data.name=synthetic", "vit.image_size=32", "vit.hidden_size=32",
        "vit.num_layers=2", "vit.num_heads=2", "vit.mlp_dim=64",
        "data.augment.out_size=32", "compute_dtype=float32",
        "pretrained_init=false",
    ]
    argv = ["extract", "ssp", "--device", "cpu", "--checkpoint", path,
            "--split", "val", "--batch-size", "64", "--out", out]
    for o in overrides:
        argv += ["-o", o]
    assert port_main(argv) == 0
    assert "256 x 128 features" in capsys.readouterr().out
    with np.load(out) as f:
        got, labels = f["features"], f["labels"]
    val = jax_synthetic(root="./datasets").split("val")
    ref, ref_labels = jt.extract_features(val, batch_size=64)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(labels, ref_labels)
    assert port_main(argv[:-2] + ["--split", "nope", "--out", out]) == 2
