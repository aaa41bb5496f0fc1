"""The port's per-op backbone paths (vit2spn_tpu_torch/models/vit.py::_block
under attn_impl="xla" and "pallas") against the JAX package's, fp32 on the
CPU, on the same numpy inputs and carried weights (models/convert.py).

"xla" is held against the JAX block with its default attention
(attn_impl=None), "pallas" against "pallas_interpret": the flash kernels in
interpret mode. Both sides compute the same fp32 function; the tolerance
(2e-5 on outputs and gradients of order 1) covers float32 reassociation and
jax.nn.gelu's erf against torch's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.core.config import ViTConfig as JViTConfig
from vit2spn_tpu.core.dtypes import FP32 as JFP32
from vit2spn_tpu.models import vit as jvit
from vit2spn_tpu_torch.core.config import ViTConfig
from vit2spn_tpu_torch.core.dtypes import FP32
from vit2spn_tpu_torch.models import vit as tvit
from vit2spn_tpu_torch.models.convert import from_jax

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
            num_heads=2, mlp_dim=64)
JAX_IMPL = {"xla": None, "pallas": "pallas_interpret"}
ATOL = 2e-5


def _params(seed):
    """JAX-initialised backbone with nonzero biases and LN params, numpy."""
    p = jax.device_get(jvit.init_vit(jax.random.key(seed), JViTConfig(**TINY)))
    rng = np.random.default_rng(seed)
    for name in ("bqkv", "bo", "b1", "b2", "ln1_bias", "ln2_bias"):
        p["blocks"][name] = (0.05 * rng.standard_normal(p["blocks"][name].shape)
                             ).astype(np.float32)
    for name in ("ln1_scale", "ln2_scale"):
        p["blocks"][name] = (1 + 0.1 * rng.standard_normal(p["blocks"][name].shape)
                             ).astype(np.float32)
    return p


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _port_grads(tp, x, cot, impl, cfg=None):
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    f = tvit.vit_features(tp, torch.from_numpy(x), cfg or ViTConfig(**TINY), FP32, impl)
    (f * torch.from_numpy(cot)).sum().backward()
    return f.detach(), {k: t.grad for k, t in leaves.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vit_forward_matches_jax(impl):
    p = _params(0)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = jvit.vit_forward(p, jnp.asarray(x), JViTConfig(**TINY), JFP32, JAX_IMPL[impl])
    got = tvit.vit_forward(from_jax(p, device="cpu"), torch.from_numpy(x),
                           ViTConfig(**TINY), FP32, impl)
    for key in ("pre_ln", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=ATOL,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vit_features_grads_match_jax(impl):
    """The features and jax.grad of sum(features * cot) over every backbone
    param (the inert pooler gets zeros on both sides)."""
    p = _params(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((3, TINY["hidden_size"])).astype(np.float32)

    def loss(pp):
        f = jvit.vit_features(pp, jnp.asarray(x), JViTConfig(**TINY), JFP32,
                              JAX_IMPL[impl])
        return jnp.sum(f * cot), f

    (_, ref_f), ref_g = jax.value_and_grad(loss, has_aux=True)(p)
    got_f, got_g = _port_grads(from_jax(p, device="cpu"), x, cot, impl)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), atol=ATOL, rtol=0)
    ref_g = _flat(jax.device_get(ref_g))
    assert got_g.keys() == ref_g.keys()
    for k, g in got_g.items():
        got = np.zeros(ref_g[k].shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(ref_g[k]), atol=ATOL, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_keeps_the_gradient_bits(impl):
    """cfg.remat "full" and "dots" recompute the blocks in the backward (all of
    it, or all but the matmul outputs): the same ops on the same values, so
    every gradient equals remat "none"'s bit for bit."""
    p = _params(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((2, TINY["hidden_size"])).astype(np.float32)
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(ViTConfig(**TINY), remat=remat)
        runs[remat] = _port_grads(from_jax(p, device="cpu"), x, cot, impl, cfg)
    f0, g0 = runs["none"]
    for remat in ("full", "dots"):
        f, g = runs[remat]
        torch.testing.assert_close(f, f0, rtol=0, atol=0)
        for k in g0:
            if g0[k] is None:
                assert g[k] is None, (remat, k)
            else:
                torch.testing.assert_close(g[k], g0[k], rtol=0, atol=0, msg=(remat, k))


def test_remat_under_no_grad_and_unknown_remat():
    p = from_jax(_params(6), device="cpu")
    x = torch.zeros((1, 32, 32, 3))
    ref = tvit.vit_features(p, x, ViTConfig(**TINY), FP32, "xla")
    with torch.no_grad():
        got = tvit.vit_features(p, x, dataclasses.replace(ViTConfig(**TINY), remat="full"),
                                FP32, "xla")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        tvit.vit_features(p, x, dataclasses.replace(ViTConfig(**TINY), remat="some"),
                          FP32, "xla")
