"""The port's ViT, heads, dual-stream network and deterministic views
against the JAX package's, on the same numpy inputs and carried weights
(models/convert.py::from_jax), fp32 on the CPU.

The JAX side runs its XLA block (attn_impl=None), whose gelu is
jax.nn.gelu's exact erf; the port's plain path uses the kernels' A&S erf,
which is within 1.5e-7 of it — hence atol 2e-5 on the features."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.core.config import SSPConfig as JSSPConfig
from vit2spn_tpu.core.dtypes import FP32 as JFP32
from vit2spn_tpu.data import augment as jaug
from vit2spn_tpu.models import heads as jheads
from vit2spn_tpu.models import ssp as jssp
from vit2spn_tpu.models import vit as jvit
from vit2spn_tpu_torch.core.config import AugmentConfig, SSPConfig, ViTConfig
from vit2spn_tpu_torch.core.dtypes import FP32
from vit2spn_tpu_torch.data import augment as taug
from vit2spn_tpu_torch.models import heads as theads
from vit2spn_tpu_torch.models import ssp as tssp
from vit2spn_tpu_torch.models import vit as tvit
from vit2spn_tpu_torch.models.convert import from_jax

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _jcfg():
    from vit2spn_tpu.core.config import ViTConfig as JViTConfig

    return JViTConfig(**TINY)


def _params(seed=0):
    """JAX-initialised backbone with nonzero biases everywhere, as numpy."""
    p = jax.device_get(jvit.init_vit(jax.random.key(seed), _jcfg()))
    rng = np.random.default_rng(seed)
    for name in ("bqkv", "bo", "b1", "b2", "ln1_bias", "ln2_bias"):
        p["blocks"][name] = (0.05 * rng.standard_normal(p["blocks"][name].shape)
                             ).astype(np.float32)
    p["blocks"]["ln1_scale"] = (1 + 0.1 * rng.standard_normal(
        p["blocks"]["ln1_scale"].shape)).astype(np.float32)
    p["patch_embed"]["bias"] = (0.05 * rng.standard_normal(
        p["patch_embed"]["bias"].shape)).astype(np.float32)
    return p


def test_init_vit_has_the_jax_layout():
    t = tvit.init_vit(torch.Generator().manual_seed(0), ViTConfig(**TINY),
                      device="cpu")
    j = jvit.init_vit(jax.random.key(0), _jcfg())
    flat_t = {"/".join(k): v for k, v in _walk(t)}
    flat_j = {"/".join(k): v for k, v in _walk(jax.device_get(j))}
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_t:
        assert tuple(flat_t[k].shape) == np.shape(flat_j[k]), k
        assert flat_t[k].dtype == torch.float32
    # trunc-normal(0.02) cut at two standard deviations, like the JAX init
    w = flat_t["blocks/wqkv"]
    assert float(w.abs().max()) <= 0.04 + 1e-7 and 0.01 < float(w.std()) < 0.02
    assert sum(v.numel() for v in flat_t.values()) == \
        sum(np.size(v) for v in flat_j.values())


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def test_patchify_orders_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(x), 16).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(x), 16)))
    g = x[..., 0].copy()
    np.testing.assert_array_equal(
        tvit.patchify_gray(torch.from_numpy(g), 16).numpy(),
        np.asarray(jvit.patchify_gray(jnp.asarray(g), 16)))


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray_fold"])
def test_vit_forward_and_features_match_jax(gray):
    p = _params()
    rng = np.random.default_rng(2)
    if gray:
        x = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
        fold = NORM
    else:
        x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
        fold = None
    ref = jvit.vit_forward(p, jnp.asarray(x), _jcfg(), JFP32, None, norm_fold=fold)
    ref_f = jvit.vit_features(p, jnp.asarray(x), _jcfg(), JFP32, None, norm_fold=fold)
    tp = from_jax(p, device="cpu")
    got = tvit.vit_forward(tp, torch.from_numpy(x), ViTConfig(**TINY), FP32,
                           norm_fold=fold, fast_gelu=False)
    got_f = tvit.vit_features(tp, torch.from_numpy(x), ViTConfig(**TINY), FP32,
                              norm_fold=fold, fast_gelu=False)
    for key in ("pre_ln", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-5, rtol=0, err_msg=key)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), atol=2e-5, rtol=0)
    # the plain-twin route gives the same numbers on the CPU
    got_p = tvit.vit_features(tp, torch.from_numpy(x), ViTConfig(**TINY), FP32,
                              attn_impl="plain", norm_fold=fold, fast_gelu=False)
    torch.testing.assert_close(got_p, got_f, rtol=0, atol=0)


def test_final_layernorm_features_match_jax():
    p = _params(3)
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jc = dataclasses.replace(_jcfg(), use_final_layernorm_features=True)
    tc = ViTConfig(**TINY, use_final_layernorm_features=True)
    ref = jvit.vit_features(p, jnp.asarray(x), jc, JFP32, None)
    got = tvit.vit_features(from_jax(p, device="cpu"), torch.from_numpy(x), tc,
                            FP32, fast_gelu=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_fold_patch_embed_gray_matches_jax():
    p = _params(4)
    kg, bg = jvit.fold_patch_embed_gray(p["patch_embed"], _jcfg(), NORM)
    tkg, tbg = tvit.fold_patch_embed_gray(from_jax(p["patch_embed"], device="cpu"),
                                          ViTConfig(**TINY), NORM)
    # fp32 sums over the 3 channels / 768 patch inputs in another order
    np.testing.assert_allclose(tkg.numpy(), np.asarray(kg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbg.numpy(), np.asarray(bg), rtol=1e-5, atol=1e-6)


def test_unknown_attn_impl_raises():
    p = from_jax(_params(), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        tvit.vit_features(p, torch.zeros(1, 32, 32, 3), ViTConfig(**TINY),
                          attn_impl="xla")


def test_mlp_head_matches_jax():
    hp = jax.device_get(jheads.init_mlp_head(jax.random.key(5), (12, 16, 8)))
    x = np.random.default_rng(5).standard_normal((4, 12)).astype(np.float32)
    ref = jheads.mlp_head_apply(hp, jnp.asarray(x))
    got = theads.mlp_head_apply(from_jax(hp, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # torch.nn.Linear init bounds
    th = theads.init_mlp_head(torch.Generator().manual_seed(0), (12, 16, 8))
    assert float(th["linear_0"]["w"].abs().max()) <= 12 ** -0.5
    assert tuple(th["linear_1"]["w"].shape) == (16, 8)


def test_mlp_head_dropout_uses_the_generator():
    hp = theads.init_mlp_head(torch.Generator().manual_seed(0), (6, 32, 4))
    x = torch.ones(8, 6)
    kw = dict(dropout_rate=0.5, dropout_after_layer=0, train=True)
    a = theads.mlp_head_apply(hp, x, generator=torch.Generator().manual_seed(1), **kw)
    b = theads.mlp_head_apply(hp, x, generator=torch.Generator().manual_seed(1), **kw)
    c = theads.mlp_head_apply(hp, x, generator=torch.Generator().manual_seed(2), **kw)
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    torch.testing.assert_close(theads.mlp_head_apply(hp, x, **{**kw, "train": False}),
                               theads.mlp_head_apply(hp, x))
    with pytest.raises(ValueError, match="generator"):
        theads.mlp_head_apply(hp, x, **kw)


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
def test_dual_stream_forward_matches_jax(dual):
    jcfg = JSSPConfig(vit=_jcfg(), dual_stream=dual, proj_hidden=48,
                      proj_dim=16, compute_dtype="float32")
    tcfg = SSPConfig(vit=ViTConfig(**TINY), dual_stream=dual, proj_hidden=48,
                     proj_dim=16, compute_dtype="float32")
    jp = jax.device_get(jssp.init_dual_stream(jax.random.key(6), jcfg))
    rng = np.random.default_rng(6)
    v1, v2 = (rng.standard_normal((3, 32, 32, 3)).astype(np.float32) for _ in range(2))
    pred_r, tgt_r = jssp.dual_stream_forward(jp, jnp.asarray(v1), jnp.asarray(v2),
                                             jcfg, JFP32)
    tp = from_jax(jp, device="cpu")
    assert isinstance(tp, tssp.DualStreamParams)
    assert tp.online["blocks"]["wqkv"].shape[0] == tssp.num_streams(tcfg)
    pred, tgt = tssp.dual_stream_forward(tp, torch.from_numpy(v1),
                                         torch.from_numpy(v2), tcfg, FP32,
                                         fast_gelu=False)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_r), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_r), atol=2e-5, rtol=0)


def test_init_dual_stream_structure():
    tcfg = SSPConfig(vit=ViTConfig(**TINY), proj_hidden=48, proj_dim=16)
    p = tssp.init_dual_stream(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert p.online["blocks"]["w1"].shape == (2, 2, 32, 64)
    assert p.heads["projection"]["linear_0"]["w"].shape == (64, 48)
    # scratch init: the nets differ; from a backbone: all equal
    assert not torch.equal(p.online["cls_token"][0], p.target["cls_token"][0])
    bb = tssp.backbone_slice(p.online, 1)
    q = tssp.init_dual_stream(torch.Generator().manual_seed(0), tcfg, bb,
                              device="cpu")
    for net in (q.online, q.target):
        for i in range(2):
            torch.testing.assert_close(net["pos_embed"][i], bb["pos_embed"])


@pytest.mark.parametrize("fold", [False, True], ids=["normalized", "fold"])
@pytest.mark.parametrize("channels", [1, 3])
def test_deterministic_views_match_jax(fold, channels):
    cfg_j = dataclasses.replace(jaug.AugmentConfig(out_size=32), enabled=False)
    cfg_t = AugmentConfig(out_size=32, enabled=False)
    u8 = np.random.default_rng(7).integers(0, 256, (3, 28, 28, channels), np.uint8)
    r1, r2 = jaug.dual_view_batch(jax.random.key(0), jnp.asarray(u8), cfg_j,
                                  fold_normalize=fold)
    g1, g2 = taug.dual_view_batch(torch.from_numpy(u8), cfg_t, fold_normalize=fold)
    np.testing.assert_allclose(g1.numpy(), np.asarray(r1), atol=2e-6, rtol=0)
    np.testing.assert_allclose(g2.numpy(), np.asarray(r2), atol=2e-6, rtol=0)
    np.testing.assert_allclose(
        taug._resize_matrix(28, 32).numpy(), np.asarray(jaug._resize_matrix(28, 32)),
        atol=1e-7)


def test_random_augmentation_is_refused():
    with pytest.raises(NotImplementedError):
        taug.augment_batch(torch.zeros((1, 8, 8, 1), dtype=torch.uint8),
                           AugmentConfig(out_size=8))
