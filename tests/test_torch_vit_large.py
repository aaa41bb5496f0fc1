"""ViT-Large/16 on the CPU: the port at D = 1024 / 16 heads / mlp 4096, the
widest geometry its kernels take, against the JAX package.

1. The ViT-Large dotted overrides (`-o vit.hidden_size=1024 -o
   vit.num_heads=16 -o vit.mlp_dim=4096 -o vit.num_layers=24`; neither CLI
   has a shorthand for it) give equal configs in both CLIs.
2. `geometry_route`: D = 1024 takes the fast route at 197 and 577 tokens,
   D = 896 (14 heads) and 800 (25 heads of 32) their routes; past
   ViT-Huge/14's D = 1280 (tests/test_torch_vit_huge.py) D = 1312 is refused
   for the LayerNorm row, head_dim 96 for the head_dim; the parity runbook
   keeps "fused" for ViT-Large on CUDA.
3. The backward twins (`mlp_bwd_plain`, `attn_bwd_plain`,
   `merged_bwd_plain`) against `_mlp_bwd_math` and `_attn_bwd_math`, and
   `fused_block` and a 2-layer `fused_backbone` (B=2, S=17) against the JAX
   `fused_block` / `fused_backbone` in interpret mode, fp32 (atol 2e-4:
   float32 reassociation) and bf16 (both round at the same points and sum in other
   orders: 4% of the output's largest magnitude, mean 0.5%), as
   tests/test_torch_model_zoo.py holds them. Weights are drawn with std
   scaled by 1 / sqrt(D / 64), as there.
4. Two SSP steps at ViT-Large width (2 layers, image 32, patch 16) against
   the JAX trainer (on a one-device mesh) from the same weights (losses
   3e-5, parameters 2e-5, the tolerances of tests/test_torch_train.py).

Inputs come from numpy with a seed and go to both sides. The CUDA kernels
at this width are held against the twins on the card by chip_smoke.py
(phase 18)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu import cli as jax_cli
from vit2spn_tpu.core.presets import PRESETS as JAX_PRESETS
from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.ops.fused_block import fused_backbone as jax_fused_backbone
from vit2spn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch import cli
from vit2spn_tpu_torch.core.config import SSPConfig, ViTConfig
from vit2spn_tpu_torch.core.presets import PRESETS
from vit2spn_tpu_torch.evals.parity import runbook_attn_impl
from vit2spn_tpu_torch.models import vit as tvit
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.ops import fused_block as fb
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

D, HEADS, MLP = 1024, 16, 4096
LARGE = ("vit.hidden_size=1024", "vit.num_heads=16", "vit.mlp_dim=4096", "vit.num_layers=24")
B, S, SP = 2, 5, 16  # the twins' inputs; SP: S padded to a multiple of 16 for the Pallas math
FWD_B, FWD_S = 2, 17  # fused_block and fused_backbone
EPS = 1e-12
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (2e-4, None), "bfloat16": (4e-2, 5e-3)}
LOSS_TOL = 3e-5
PARAM_TOL = 2e-5


# ---------------------------------------------------------------------------
# 1. the overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["ssp-scratch", "ft-octmnist"])
def test_vit_large_overrides_match_jax(preset):
    got = cli._apply_overrides(PRESETS[preset], list(LARGE))
    ref = jax_cli._apply_overrides(JAX_PRESETS[preset], list(LARGE))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    vit = got.vit
    assert (vit.hidden_size, vit.num_heads, vit.mlp_dim, vit.num_layers) == (D, HEADS, MLP, 24)
    assert (vit.head_dim, vit.seq_len) == (64, 197)


# ---------------------------------------------------------------------------
# 2. the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d, heads, mlp, s, route", [
    (1024, 16, 4096, 197, "fast"),   # ViT-Large/16 at 224 px
    (1024, 16, 4096, 577, "fast"),   # at 384 px: the long routes
    (896, 14, 3584, 197, "fast"),    # a width between: the mma.sync backward sequences
    (800, 25, 3200, 197, "general"),  # head_dim 32, D a multiple of 32 only
], ids=["large_224px", "large_384px", "d896", "d800"])
def test_geometry_route_takes_vit_large(d, heads, mlp, s, route):
    assert fb.geometry_route(d, heads, mlp, s) == (route, "")
    assert fb.check_geometry(d, heads, mlp, s) == route


@pytest.mark.parametrize("d, heads, mlp, message", [
    (1312, 41, 5248, "D a multiple of 32 with D <= 1280, got D=1312"),
    (1408, 16, 6144, "D <= 1280, got D=1408"),  # ViT-g/14: head_dim 88 too
    (1152, 12, 4608, "head_dim in (16, 32, 48, 64, 80); got D=1152, heads=12"),
], ids=["d1312", "vit_giant", "dh96"])
def test_geometry_route_refuses_past_vit_large(d, heads, mlp, message):
    route, why = fb.geometry_route(d, heads, mlp, 197)
    assert route is None and message in why


def test_runbook_takes_the_kernels_at_vit_large():
    vit = ViTConfig(hidden_size=D, num_heads=HEADS, mlp_dim=MLP, num_layers=24)
    assert runbook_attn_impl(vit, "cuda") == "fused"
    assert runbook_attn_impl(vit, "cuda", "float32") == "fused"


# ---------------------------------------------------------------------------
# 3. the twins and the fused functions at D = 1024
# ---------------------------------------------------------------------------

def _weights(rng, layers=None):
    """Block weights (stacked over `layers` when given), std scaled by
    1 / sqrt(D / 64) so the outputs and gradients keep the magnitudes of the
    narrow tests' cases; W1 large enough that the gelu forms differ."""
    lead = () if layers is None else (layers,)
    k = (64 / D) ** 0.5

    def n(*shape, std):
        return (rng.standard_normal(lead + shape) * std).astype(np.float32)

    return {
        "ln1_scale": 1.0 + n(D, std=0.1), "ln1_bias": n(D, std=0.1),
        "wqkv": n(D, 3 * D, std=0.1 * k), "bqkv": n(3 * D, std=0.05),
        "wo": n(D, D, std=0.1 * k), "bo": n(D, std=0.05),
        "ln2_scale": 1.0 + n(D, std=0.1), "ln2_bias": n(D, std=0.1),
        "w1": n(D, MLP, std=0.4 * k), "b1": n(MLP, std=0.05),
        "w2": n(MLP, D, std=0.1 * k), "b2": n(D, std=0.05),
    }


def _typed(w, jdt, tdt):
    """(jax tuple, torch tuple) in WEIGHT_NAMES order: LN params fp32, the
    rest in the compute dtype."""
    j = tuple(jnp.asarray(w[n], jnp.float32 if n.startswith("ln") else jdt)
              for n in fb.WEIGHT_NAMES)
    t = tuple(torch.from_numpy(w[n]).to(torch.float32 if n.startswith("ln") else tdt)
              for n in fb.WEIGHT_NAMES)
    return j, t


def _pad(a, jdt):
    return jnp.pad(jnp.asarray(a, jdt), ((0, 0), (0, SP - S), (0, 0))).reshape(B * SP, -1)


def _unpad(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).reshape(B, SP, D)[:, :S]


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
def test_backward_twins_match_pallas_math_at_vit_large(dtype, half, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "0")
    rng = np.random.default_rng(1024)
    w = _weights(rng)
    x, x2 = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((B, S, D))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
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
        ref_dx, ref_g = jfb._attn_bwd_math(_pad(x, jdt), _pad(g, jdt), jw, B, SP, D, HEADS, S,
                                           EPS, jdt)
        got_dx, got = fb.attn_bwd_plain(t(x), t(g), tw, HEADS, EPS)
        names = fb.ATTN_NAMES
    else:  # dx2 crosses in the compute dtype, as the merged kernel hands it on
        ref_dx, ga = jfb._attn_bwd_math(_pad(x, jdt), jnp.asarray(ref_dx2).astype(jdt), jw, B,
                                        SP, D, HEADS, S, EPS, jdt)
        ref_g.update(ga)
        got_dx, got = fb.merged_bwd_plain(t(x), t(x2), t(g), tw, HEADS, EPS, False)
        names = fb.WEIGHT_NAMES
    assert got_dx.dtype == tdt
    _close(got_dx.float(), _unpad(jnp.asarray(ref_dx).astype(jdt)), dtype, "dx")
    for n in names:
        assert got[n].dtype == torch.float32, n
        _close(got[n], np.asarray(ref_g[n]).reshape(w[n].shape), dtype, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_matches_jax_at_vit_large(dtype, monkeypatch):
    """One block through the port's `fused_block` (on the CPU the layer
    kernel's plain twin) against the JAX `fused_block` (its Pallas forward
    in interpret mode); the backward at this width is the twins' test
    above."""
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "0")
    rng = np.random.default_rng(1025)
    w = _weights(rng)
    x = rng.standard_normal((FWD_B, FWD_S, D)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(w, jdt, tdt)
    ref = jfb.fused_block(jnp.asarray(x, jdt), jw, HEADS, EPS, FWD_B, True)
    got = fb.fused_block(torch.from_numpy(x).to(tdt), tw, HEADS, EPS, fast_gelu=False)
    assert got.dtype == tdt and got.shape == (FWD_B, FWD_S, D)
    _close(got.float(), jnp.asarray(ref).astype(jnp.float32), dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_backbone_matches_jax_at_vit_large(dtype, monkeypatch):
    """Two layers through the port's `fused_backbone` (on the CPU its plain
    twin) against the JAX `fused_backbone` in interpret mode."""
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "0")
    rng = np.random.default_rng(1026)
    w = _weights(rng, layers=2)
    x = rng.standard_normal((FWD_B, FWD_S, D)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(w, jdt, tdt)
    ref = jax_fused_backbone(jnp.asarray(x, jdt), jw, HEADS, EPS, FWD_B, True)
    got = fb.fused_backbone(torch.from_numpy(x).to(tdt), tw, HEADS, EPS, fast_gelu=False)
    assert got.dtype == tdt and got.shape == (FWD_B, FWD_S, D)
    _close(got.float(), jnp.asarray(ref).astype(jnp.float32), dtype, "out")


# ---------------------------------------------------------------------------
# 4. two SSP steps at ViT-Large width against the JAX trainer
# ---------------------------------------------------------------------------

def _port_cfg(jcfg):
    from vit2spn_tpu_torch.core import config as tcfg

    d = dataclasses.asdict(jcfg)
    return SSPConfig(
        vit=tcfg.ViTConfig(**d.pop("vit")),
        data=tcfg.DataConfig(**{**d["data"], "augment": tcfg.AugmentConfig(
            **d["data"]["augment"])}),
        mesh=tcfg.MeshConfig(**d.pop("mesh")),
        **{k: v for k, v in d.items() if k != "data"},
    )


def test_vit_large_ssp_steps_match_jax(tiny_ssp, monkeypatch):
    """Two optimizer steps (2 microbatches of 8, Adam, EMA) at ViT-Large's
    width and heads, 2 layers, 32 px, fp32; augmentation and dropout off (the
    two packages draw different random bits by design). The port's random
    init is replaced by the JAX trainer's weights, so it is not drawn (its
    truncated normals at this width take ~10 s on one CPU thread)."""
    monkeypatch.setattr(tvit, "_trunc_normal", lambda gen, shape, std=0.02: torch.zeros(shape))
    jcfg = jax_cli._apply_overrides(tiny_ssp, list(LARGE[:3]))
    jcfg = dataclasses.replace(
        jcfg, proj_dropout=0.0,
        data=dataclasses.replace(jcfg.data, augment=dataclasses.replace(
            jcfg.data.augment, enabled=False)))
    vit = jcfg.vit
    assert (vit.hidden_size, vit.num_heads, vit.mlp_dim, vit.num_layers, vit.image_size) == (
        D, HEADS, MLP, 2, 32)
    jt = JaxSSPTrainer(jcfg, logger=JaxLogger(echo=False), mesh=jax_make_mesh(jax.devices()[:1]))
    pt = SSPTrainer(_port_cfg(jcfg), logger=MetricLogger(echo=False), device="cpu")
    pt.state = pt.state._replace(params=from_jax(jax.device_get(jt.state.params),
                                                 device="cpu"))
    ds = jax_synthetic(image_size=28, split_sizes={"train": 32}, seed=9)
    eff = jcfg.effective_batch
    for s in range(2):
        batch = ds.images[s * eff:(s + 1) * eff]
        ref = float(jt.train_step(batch, jax.random.key(s))["loss"])
        got = float(pt.train_step(batch, (0, s))["loss"])
        np.testing.assert_allclose(got, ref, atol=LOSS_TOL, rtol=0, err_msg=f"step {s}")
    ref = jax.tree_util.tree_flatten_with_path(jax.device_get(jt.state.params))[0]
    got = ckpt._flatten(pt.state.params)
    assert len(ref) == len(got)
    for path, leaf in ref:
        key = jckpt._path_key(path)
        np.testing.assert_allclose(got[key], np.asarray(leaf), atol=PARAM_TOL, rtol=0,
                                   err_msg=key)
    assert got["online/blocks/w1"].shape[-3:] == (2, D, MLP)
