"""The model zoo on the CPU: the port's ViT-Small/16 and ViT-Base/16 widths
(`-o vit=small|base`) against the JAX package.

1. The overrides: the two CLIs' `_apply_overrides` give equal configs.
2. The backward twins (`mlp_bwd_plain`, `attn_bwd_plain`,
   `merged_bwd_plain`) at D = 384 / 6 heads / mlp 1536 and D = 768 / 12 heads
   / mlp 3072 against `_mlp_bwd_math` and `_attn_bwd_math`, fp32 (atol
   2e-4: float32 reassociation, as tests/test_torch_backward.py) and bf16
   (its bf16 tolerance: both round at the same points and sum in other
   orders, so a value near a rounding boundary lands one bf16 step away: 4%
   of the output's largest magnitude, mean 0.5%). Weights are drawn with
   std scaled by 1 / sqrt(D / 64) so the gradients keep the magnitudes of
   that file's D = 64 case.
3. Two SSP steps at ViT-Small width (2 layers, image 32, patch 16) against
   the JAX trainer from the same weights, with the tolerances of
   tests/test_torch_train.py (losses 3e-5, parameters 2e-5).
4. `run ssp-scratch -o vit=small` on the CPU, then `run
   ssp-ssl/ft-octmnist -o vit=small` from its export.

Inputs come from numpy with a seed and go to both sides."""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu import cli as jax_cli
from vit2spn_tpu.core.presets import PRESETS as JAX_PRESETS
from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch import cli
from vit2spn_tpu_torch.core.presets import PRESETS
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.ops import fused_block as fb
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

ZOO = {"small": (384, 6, 1536), "base": (768, 12, 3072)}
B, S, SP = 2, 5, 16  # SP: S padded to a multiple of 16, as the Pallas math takes it
EPS = 1e-12
TOL = {"float32": (2e-4, None), "bfloat16": (4e-2, 5e-3)}
LOSS_TOL = 3e-5
PARAM_TOL = 2e-5


# ---------------------------------------------------------------------------
# 1. the overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vit", ["small", "base"])
@pytest.mark.parametrize("preset", ["ssp", "ssp-scratch", "ft-octmnist"])
def test_vit_override_matches_jax(preset, vit):
    got = cli._apply_overrides(PRESETS[preset], [f"vit={vit}"])
    ref = jax_cli._apply_overrides(JAX_PRESETS[preset], [f"vit={vit}"])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    d, heads, mlp = ZOO[vit]
    assert (got.vit.hidden_size, got.vit.num_heads, got.vit.mlp_dim) == (d, heads, mlp)
    assert got.vit.num_layers == 12 and got.vit.hidden_size // got.vit.num_heads == 64


# ---------------------------------------------------------------------------
# 2. the backward twins at the zoo's widths
# ---------------------------------------------------------------------------

def _layer(seed, d, mlp):
    rng = np.random.default_rng(seed)
    k = (64 / d) ** 0.5

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    w = {
        "ln1_scale": 1.0 + n(d, std=0.1), "ln1_bias": n(d, std=0.1),
        "wqkv": n(d, 3 * d, std=0.1 * k), "bqkv": n(3 * d, std=0.05),
        "wo": n(d, d, std=0.1 * k), "bo": n(d, std=0.05),
        "ln2_scale": 1.0 + n(d, std=0.1), "ln2_bias": n(d, std=0.1),
        "w1": n(d, mlp, std=0.4 * k), "b1": n(mlp, std=0.05),
        "w2": n(mlp, d, std=0.1 * k), "b2": n(d, std=0.05),
    }
    x, x2 = (rng.standard_normal((B, S, d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((B, S, d))).astype(np.float32)
    return w, x, x2, g


def _pad(a, jdt):
    return jnp.pad(jnp.asarray(a, jdt), ((0, 0), (0, SP - S), (0, 0))).reshape(B * SP, -1)


def _unpad(a, d):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).reshape(B, SP, d)[:, :S]


def _close(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    atol, mean_tol = TOL[dtype]
    if mean_tol is None:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-4, err_msg=what)
        return
    mx = float(np.abs(ref).max()) or 1.0
    err = np.abs(got - ref)
    assert err.max() <= atol * mx, (what, float(err.max()), mx)
    assert err.mean() <= mean_tol * mx, (what, float(err.mean()), mx)


@pytest.mark.parametrize("half", ["mlp", "attn", "merged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vit", ["small", "base"])
def test_backward_twins_match_pallas_math(vit, dtype, half, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "0")
    d, heads, mlp = ZOO[vit]
    w, x, x2, g = _layer(d, d, mlp)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jdt) for k, v in w.items()}
    tw = {k: torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else tdt)
          for k, v in w.items()}

    def t(a):
        return torch.from_numpy(a).to(tdt)

    ref_g = {}
    if half in ("mlp", "merged"):
        ref_dx2, gm = jfb._mlp_bwd_math(_pad(x2, jdt), _pad(g, jdt), jw, jdt, EPS)
        ref_g.update(gm)
    if half == "mlp":
        got_dx, got = fb.mlp_bwd_plain(t(x2), t(g), tw, EPS, False)
        ref_dx, names = ref_dx2, fb.MLP_NAMES
    elif half == "attn":
        ref_dx, ref_g = jfb._attn_bwd_math(_pad(x, jdt), _pad(g, jdt), jw, B, SP, d, heads, S,
                                           EPS, jdt)
        got_dx, got = fb.attn_bwd_plain(t(x), t(g), tw, heads, EPS)
        names = fb.ATTN_NAMES
    else:  # dx2 crosses in the compute dtype, as the merged kernel hands it on
        ref_dx, ga = jfb._attn_bwd_math(_pad(x, jdt), jnp.asarray(ref_dx2).astype(jdt), jw, B,
                                        SP, d, heads, S, EPS, jdt)
        ref_g.update(ga)
        got_dx, got = fb.merged_bwd_plain(t(x), t(x2), t(g), tw, heads, EPS, False)
        names = fb.WEIGHT_NAMES
    assert got_dx.dtype == tdt
    _close(got_dx.float(), _unpad(jnp.asarray(ref_dx).astype(jdt), d), dtype, "dx")
    for n in names:
        assert got[n].dtype == torch.float32, n
        _close(got[n], np.asarray(ref_g[n]).reshape(w[n].shape), dtype, n)


# ---------------------------------------------------------------------------
# 3. two SSP steps at ViT-Small width against the JAX trainer
# ---------------------------------------------------------------------------

def _port_cfg(jcfg):
    from vit2spn_tpu_torch.core import config as tcfg

    d = dataclasses.asdict(jcfg)
    return tcfg.SSPConfig(
        vit=tcfg.ViTConfig(**d.pop("vit")),
        data=tcfg.DataConfig(**{**d["data"], "augment": tcfg.AugmentConfig(
            **d["data"]["augment"])}),
        mesh=tcfg.MeshConfig(**d.pop("mesh")),
        **{k: v for k, v in d.items() if k != "data"},
    )


def test_vit_small_ssp_steps_match_jax(tiny_ssp):
    """Two optimizer steps (2 microbatches of 8, Adam, EMA) at ViT-Small's
    width and heads, 2 layers, 32 px, fp32; augmentation and dropout off (the
    two packages draw different random bits by design)."""
    jcfg = jax_cli._apply_overrides(tiny_ssp, ["vit=small"])
    jcfg = dataclasses.replace(
        jcfg, proj_dropout=0.0,
        data=dataclasses.replace(jcfg.data, augment=dataclasses.replace(
            jcfg.data.augment, enabled=False)))
    assert (jcfg.vit.hidden_size, jcfg.vit.num_layers, jcfg.vit.image_size) == (384, 2, 32)
    jt = JaxSSPTrainer(jcfg, logger=JaxLogger(echo=False))
    pt = SSPTrainer(_port_cfg(jcfg), logger=MetricLogger(echo=False), device="cpu")
    pt.state = pt.state._replace(params=from_jax(jax.device_get(jt.state.params),
                                                 device="cpu"))
    ds = jax_synthetic(image_size=28, split_sizes={"train": 32}, seed=8)
    eff = jcfg.effective_batch
    losses = []
    for s in range(2):
        batch = ds.images[s * eff:(s + 1) * eff]
        ref = float(jt.train_step(batch, jax.random.key(s))["loss"])
        got = float(pt.train_step(batch, (0, s))["loss"])
        np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0, err_msg=f"step {s}")
        losses.append(got)
    from vit2spn_tpu.train import checkpoint as jckpt

    ref = jax.tree_util.tree_flatten_with_path(jax.device_get(jt.state.params))[0]
    got = ckpt._flatten(pt.state.params)
    assert len(ref) == len(got)
    for path, leaf in ref:
        key = jckpt._path_key(path)
        np.testing.assert_allclose(got[key], np.asarray(leaf), atol=PARAM_TOL, rtol=0,
                                   err_msg=key)
    assert got["online/blocks/w1"].shape[-3:] == (2, 384, 1536)  # (streams,) layers, D, mlp


# ---------------------------------------------------------------------------
# 4. the CLI at ViT-Small: SSP, then a fine-tune from its export
# ---------------------------------------------------------------------------

SMALL = ["data.name=synthetic", "vit=small", "vit.image_size=32", "vit.num_layers=1",
         "data.augment.out_size=32", "compute_dtype=float32", "batch_size=8"]


def _argv(*head, overrides):
    argv = list(head)
    for o in overrides:
        argv += ["-o", o]
    return argv


def test_run_ssp_then_finetune_at_vit_small(tmp_path):
    out = tmp_path / "ssp"
    assert cli.main(_argv("run", "ssp-scratch", "--device", "cpu", "--epochs", "1",
                          "--output-dir", str(out),
                          overrides=SMALL + ["accumulation_steps=2"])) == 0
    export = out / "octmnist_vit2spn_tiny_scratch_model.npz"
    with np.load(export) as z:
        shapes = {k: z[k].shape for k in z.files}
    assert (1, 384, 1536) in shapes.values(), shapes
    ft = tmp_path / "ft"
    overrides = SMALL + ["data.subset_fraction=0.02", "data.test_subset_size=24", "k_folds=2",
                         "head_hidden=16", "init=scratch", f"init_path={export}"]
    assert cli.main(_argv("run", "ssp-ssl/ft-octmnist", "--device", "cpu", "--epochs", "1",
                          "--output-dir", str(ft), overrides=overrides)) == 0
    with open(ft / "synthetic_cv_result.json") as f:
        payload = json.load(f)
    assert len(payload["fold_aucs"]) == 2 and all(np.isfinite(payload["fold_aucs"]))
    events = [json.loads(l)["event"] for l in open(ft / "metrics.jsonl")]
    assert "cv_summary" in events
