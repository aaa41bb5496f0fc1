"""The port's augmentation stack (vit2spn_tpu_torch/data/augment.py) against
the JAX package's, stage by stage, on the CPU.

The two packages draw different random bits (core/rng.py), so every stage is
compared on parameters the test draws with `jax.random` through the JAX
package's own key splits and hands to both sides; the port's own sampler is
checked for its distributions. Tolerances: fp32 stages agree to float32
reassociation (2e-6 on [0, 1] pixels; 1e-5 through the warp, a tent-weight
GEMM in JAX and a bilinear gather in the port); the warp in bf16 rounds its
tent weights and row sums to bf16 in JAX and only its output in the port:
2e-2 (about five bf16 steps at 1.0), mean 2e-3."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.core.config import AugmentConfig as JaxAugmentConfig
from vit2spn_tpu.data import augment as jaug
from vit2spn_tpu_torch.core.config import AugmentConfig
from vit2spn_tpu_torch.data import augment as aug

torch.set_num_threads(1)

B = 6
CFG = AugmentConfig(out_size=48)
JCFG = JaxAugmentConfig(out_size=48)


def _raw_affine(k, cfg):
    """The draws of `_sample_affine` under its own key splits."""
    ks = jax.random.split(k, 7)
    return dict(
        hflip=jax.random.bernoulli(ks[0], cfg.hflip_prob),
        vflip=jax.random.bernoulli(ks[1], cfg.vflip_prob),
        rot1=jaug._deg2rad(jax.random.uniform(
            ks[2], minval=-cfg.rotation_degrees, maxval=cfg.rotation_degrees)),
        rot2=jaug._deg2rad(jax.random.uniform(
            ks[3], minval=-cfg.affine_degrees, maxval=cfg.affine_degrees)),
        translate=jax.random.uniform(ks[4], (2,), minval=-1.0, maxval=1.0),
        scale=jax.random.uniform(ks[5], minval=cfg.affine_scale[0],
                                 maxval=cfg.affine_scale[1]),
        shear=jaug._deg2rad(jax.random.uniform(
            ks[6], minval=-cfg.affine_shear, maxval=cfg.affine_shear)),
    )


def _jax_params(key, b, cfg, out_hw):
    """AugParams holding exactly what `_augment_batch_impl` draws from
    `key`: affine per image from split(kg, b), jitter from kj, blur from
    kb, erasing from ke."""
    kg, kj, kb, ke = jax.random.split(key, 4)
    raw = jax.vmap(lambda k: _raw_affine(k, cfg))(jax.random.split(kg, b))
    kb_, kc_, ko_ = jax.random.split(kj, 3)
    j = cfg.jitter_brightness, cfg.jitter_contrast
    ks = jax.random.split(ke, 5)
    h, w = out_hw
    vals = dict(
        raw,
        bright=jax.random.uniform(kb_, (b, 1, 1), minval=1 - j[0], maxval=1 + j[0]),
        contrast=jax.random.uniform(kc_, (b, 1, 1), minval=1 - j[1], maxval=1 + j[1]),
        bright_first=jax.random.bernoulli(ko_, 0.5, (b, 1, 1)),
        sigma=jax.random.uniform(kb, (b, 1, 1), minval=cfg.blur_sigma[0],
                                 maxval=cfg.blur_sigma[1]),
        erase=jax.random.bernoulli(ks[0], cfg.erasing_prob, (b, 1, 1)),
        erase_area=h * w * jax.random.uniform(
            ks[1], (b,), minval=cfg.erasing_scale[0], maxval=cfg.erasing_scale[1]),
        erase_ratio=jnp.exp(jax.random.uniform(
            ks[2], (b,), minval=jnp.log(cfg.erasing_ratio[0]),
            maxval=jnp.log(cfg.erasing_ratio[1]))),
        erase_i=jax.random.uniform(ks[3], (b,)),
        erase_j=jax.random.uniform(ks[4], (b,)),
    )
    return aug.AugParams(**{k: torch.from_numpy(np.array(v)).reshape(
        (b, 2) if k == "translate" else (b,)) for k, v in vals.items()})


def _gray(seed, b=B, s=28):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:s, 0:s] / s
    base = 0.5 + 0.4 * np.sin(6 * x + 3 * y) * np.cos(4 * y)
    imgs = base[None] + rng.normal(0, 0.05, (b, s, s))
    return np.clip(imgs, 0, 1).astype(np.float32)


def _close(got, ref, atol, mean=None):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert err.max() <= atol, float(err.max())
    if mean is not None:
        assert err.mean() <= mean, float(err.mean())


def test_affine_composition_matches_sample_affine():
    key = jax.random.key(1)
    keys = jax.random.split(key, 64)
    inv_r, trans_r = jax.vmap(lambda k: jaug._sample_affine(k, JCFG, 28, 28))(keys)
    raw = jax.vmap(lambda k: _raw_affine(k, JCFG))(keys)
    p = aug.AugParams(**{f: torch.zeros(64) for f in aug.AugParams._fields})._replace(
        **{k: torch.from_numpy(np.array(v)) for k, v in raw.items()})
    inv, trans = aug.affine_from_params(p, CFG, 28, 28)
    _close(inv, inv_r, 2e-6)
    np.testing.assert_array_equal(trans.numpy(), np.asarray(trans_r))
    assert bool(p.hflip.any()) and bool((~p.hflip).any())  # both branches seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_matches_jax(dtype):
    key = jax.random.key(2)
    inv, trans = jax.vmap(lambda k: jaug._sample_affine(k, JCFG, 28, 28))(
        jax.random.split(key, B))
    imgs = _gray(0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    ref = jaug._warp_batch(jnp.asarray(imgs, jdt), inv, trans, 48, 64, jdt)
    got = aug.warp(torch.from_numpy(imgs).to(tdt), torch.from_numpy(np.array(inv)),
                   torch.from_numpy(np.array(trans)), 48, 64)
    assert got.dtype == tdt and got.shape == (B, 48, 48)
    if dtype == "float32":
        _close(got.float(), ref, 1e-5)
    else:
        _close(got.float(), jnp.asarray(ref, jnp.float32), 2e-2, mean=2e-3)


def test_photometric_stages_match_jax():
    """Jitter (both orders), blur (reflect padding) and erasing on the JAX
    sampler's draws."""
    imgs = _gray(1, s=48)
    key = jax.random.key(3)
    p = _jax_params(key, B, JCFG, (48, 48))
    kg, kj, kb, ke = jax.random.split(key, 4)
    x = torch.from_numpy(imgs)
    ref = jaug._color_jitter_gray_batch(kj, jnp.asarray(imgs), JCFG)
    got = aug.color_jitter(x, p.bright, p.contrast, p.bright_first)
    _close(got, ref, 2e-6)
    assert bool(p.bright_first.any()) and bool((~p.bright_first).any())
    ref = jaug._gaussian_blur3_batch(kb, jnp.asarray(imgs), JCFG)
    _close(aug.gaussian_blur3(x, p.sigma), ref, 2e-6)
    ref = jaug._random_erasing_batch(ke, jnp.asarray(imgs), JCFG)
    got = aug.random_erasing(x, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() == 0).any()


def test_band_limit_and_mid_size_match_jax():
    rng = np.random.default_rng(2)
    for h, w in ((100, 120), (28, 28), (96, 96), (64, 80)):
        imgs = rng.random((2, h, w)).astype(np.float32)
        got = aug._band_limit(torch.from_numpy(imgs), 96)
        ref = jaug._band_limit(jnp.asarray(imgs), 96)
        _close(got, ref, 2e-6)
    for s in (28, 48, 49, 96):
        assert aug._mid_size_for(s) == jaug._mid_size_for(s)


@pytest.mark.parametrize("fold", [True, False], ids=["fold_normalize", "normalize"])
def test_whole_stack_matches_jax_on_its_draws(fold):
    """uint8 -> the random stack -> the normalized or pre-normalize view,
    against `_augment_batch_impl` with the same key's draws, fp32."""
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (B, 28, 28, 1), dtype=np.uint8)
    key = jax.random.key(5)
    ref = jaug._augment_batch_impl(key, jnp.asarray(u8), JCFG, jnp.float32, fold)
    p = _jax_params(key, B, JCFG, (48, 48))
    gray = aug._band_limit(aug._to_gray(torch.from_numpy(u8)), CFG.band_limit)
    got = aug._normalize(aug.apply_params(gray, p, CFG), CFG, torch.float32, fold)
    _close(got, ref, 5e-5 if not fold else 1e-5)


def test_sampler_distributions():
    """The port's own draws, over 4000 images: every parameter in its
    torchvision range, and the flip, erase and jitter-order rates within
    4.5 standard deviations of their probabilities."""
    n = 4000
    gen = torch.Generator().manual_seed(0)
    p = aug.sample_params(gen, n, CFG, (224, 224))
    deg = math.pi / 180
    assert float(p.rot1.abs().max()) <= 30 * deg and float(p.rot1.abs().max()) > 29 * deg
    assert float(p.rot2.abs().max()) <= 15 * deg
    assert float(p.shear.abs().max()) <= 10 * deg
    assert float(p.translate.abs().max()) <= 1.0
    assert 0.8 <= float(p.scale.min()) and float(p.scale.max()) <= 1.2
    for f in (p.bright, p.contrast):
        assert 0.7 <= float(f.min()) and float(f.max()) <= 1.3
    assert 0.1 <= float(p.sigma.min()) and float(p.sigma.max()) <= 2.0
    area = p.erase_area / (224 * 224)
    assert 0.02 <= float(area.min()) and float(area.max()) <= 0.2
    assert 0.3 <= float(p.erase_ratio.min()) and float(p.erase_ratio.max()) <= 3.3
    # log-uniform ratio: the median sits at sqrt(0.3 * 3.3) ~ 0.995
    assert abs(float(p.erase_ratio.median()) - math.sqrt(0.99)) < 0.1
    for flag, prob in ((p.hflip, 0.5), (p.vflip, 0.3), (p.erase, 0.5),
                       (p.bright_first, 0.5)):
        sd = math.sqrt(prob * (1 - prob) / n)
        assert abs(float(flag.float().mean()) - prob) < 4.5 * sd
    # the jitter order matters: the two orders give different pixels
    x = torch.from_numpy(_gray(3, b=1))
    f = torch.tensor([1.3])
    a = aug.color_jitter(x, f, torch.tensor([0.7]), torch.tensor([True]))
    b = aug.color_jitter(x, f, torch.tensor([0.7]), torch.tensor([False]))
    assert float((a - b).abs().max()) > 1e-3


def test_augment_batch_draws_from_its_generator():
    u8 = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (4, 28, 28, 1),
                                                             dtype=np.uint8))
    with pytest.raises(ValueError, match="generator"):
        aug.augment_batch(u8, CFG)
    a = aug.augment_batch(u8, CFG, generator=torch.Generator().manual_seed(1))
    b = aug.augment_batch(u8, CFG, generator=torch.Generator().manual_seed(1))
    assert a.shape == (4, 48, 48, 3) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    v1, v2 = aug.dual_view_batch(u8, CFG, torch.bfloat16, fold_normalize=True,
                                 generator=torch.Generator().manual_seed(1))
    assert v1.shape == (4, 48, 48) and v1.dtype == torch.bfloat16
    assert float((v1.float() - v2.float()).abs().max()) > 0.1  # independent draws
    off = dataclasses.replace(CFG, enabled=False)
    d1, d2 = aug.dual_view_batch(u8, off)
    assert d1 is d2
