"""The port's backbone backward (vit2spn_tpu_torch/ops/fused_block.py)
against the JAX package's Pallas backward math, run on the CPU.

`mlp_bwd_plain` and `attn_bwd_plain` are the plain twins of the two CUDA
backward kernels; they are held against `_mlp_bwd_math` and `_attn_bwd_math`
called directly on jnp arrays. The whole-backbone gradients of the port's
`fused_backbone` (its autograd Function, running the twins on the CPU) are
held against `jax.grad` of the JAX `fused_backbone` in interpret mode. The
CUDA kernels themselves are held against the twins on the card by
chip_smoke.py. Inputs come from numpy with a seed and go to both sides."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit2spn_tpu_torch.ops import fused_block as fb

# the module, not the `fused_block` function vit2spn_tpu.ops exports
jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

L, D, HEADS, MLP, S, B = 2, 64, 2, 128, 5, 3
SP = 16  # S padded to a multiple of 16, as the Pallas kernels take it
EPS = 1e-12
BF16 = {"jax": jnp.bfloat16, "torch": torch.bfloat16}
F32 = {"jax": jnp.float32, "torch": torch.float32}


def _weights(seed, layers=L):
    """Stacked block weights with nonzero biases and LN params; W1 large
    enough that the MLP pre-activations reach where the gelu forms differ."""
    rng = np.random.default_rng(seed)

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    ws = {
        "ln1_scale": 1.0 + n(layers, D, std=0.1), "ln1_bias": n(layers, D, std=0.1),
        "wqkv": n(layers, D, 3 * D, std=0.1), "bqkv": n(layers, 3 * D, std=0.05),
        "wo": n(layers, D, D, std=0.1), "bo": n(layers, D, std=0.05),
        "ln2_scale": 1.0 + n(layers, D, std=0.1), "ln2_bias": n(layers, D, std=0.1),
        "w1": n(layers, D, MLP, std=0.4), "b1": n(layers, MLP, std=0.05),
        "w2": n(layers, MLP, D, std=0.1), "b2": n(layers, D, std=0.05),
    }
    return rng, ws


def _as_dtype(ws, dt):
    """LN params fp32, the rest in the compute dtype (the kernels' types)."""
    return {k: (v if k.startswith("ln") else v.astype(dt)) for k, v in ws.items()}


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _pad(x):
    """(B, S, D) -> (B*SP, D) with zero pad rows, as the Pallas kernels see it."""
    return jnp.pad(x, ((0, 0), (0, SP - S), (0, 0))).reshape(B * SP, -1)


def _unpad(a):
    return np.asarray(a, np.float32).reshape(B, SP, -1)[:, :S]


# fp32: every rounding point is the identity, so the two sides differ by
# float32 reassociation only (gradients here reach ~10: 2e-4 absolute).
# bf16: both sides round to bf16 at the same points but sum in different
# orders, so a value near a rounding boundary can land one bf16 step away
# and carry that step on: 4% of the largest magnitude, and the mean error
# within 0.5% of it.
TOL = {"float32": (2e-4, None), "bfloat16": (4e-2, 5e-3)}


def _close(got, ref, dtype, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    mx = float(np.abs(ref).max()) or 1.0
    atol, mean_tol = TOL[dtype]
    if mean_tol is None:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-4, err_msg=what)
    else:
        err = np.abs(got - ref)
        assert err.max() <= atol * mx, (what, float(err.max()), mx)
        assert err.mean() <= mean_tol * mx, (what, float(err.mean()), mx)


@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_bwd_plain_matches_pallas_math(dtype, fast, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    rng, ws = _weights(0)
    x2 = rng.standard_normal((B, S, D)).astype(np.float32)
    dout = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    w = {k: v[0] for k, v in _as_dtype(ws, np.float32).items()}
    jdt, tdt = (BF16 if dtype == "bfloat16" else F32).values()
    jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jdt)
          for k, v in w.items()}
    ref_dx2, ref_g = jfb._mlp_bwd_math(_pad(jnp.asarray(x2, jdt)),
                                       _pad(jnp.asarray(dout, jdt)), jw, jdt, EPS)
    tw = {k: _t(v, torch.float32 if k.startswith("ln") else tdt) for k, v in w.items()}
    dx2, grads = fb.mlp_bwd_plain(_t(x2, tdt), _t(dout, tdt), tw, EPS, fast)
    assert dx2.dtype == tdt
    # the kernel emits dx2 in compute dtype; the Pallas math hands it on fp32
    _close(dx2.float(), _unpad(jnp.asarray(ref_dx2).astype(jdt)), dtype, "dx2")
    for n in fb.MLP_NAMES:
        assert grads[n].dtype == torch.float32
        _close(grads[n], ref_g[n], dtype, n)


@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_bwd_plain_matches_pallas_math(dtype, fast, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    rng, ws = _weights(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dx2 = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    w = {k: v[0] for k, v in ws.items()}
    jdt, tdt = (BF16 if dtype == "bfloat16" else F32).values()
    jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jdt)
          for k, v in w.items()}
    ref_dx, ref_g = jfb._attn_bwd_math(
        _pad(jnp.asarray(x, jdt)), _pad(jnp.asarray(dx2, jdt)), jw, B, SP, D,
        HEADS, S, EPS, jdt)
    tw = {k: _t(v, torch.float32 if k.startswith("ln") else tdt) for k, v in w.items()}
    dx, grads = fb.attn_bwd_plain(_t(x, tdt), _t(dx2, tdt), tw, HEADS, EPS)
    assert dx.dtype == tdt
    _close(dx.float(), _unpad(jnp.asarray(ref_dx).astype(jdt)), dtype, "dx")
    for n in fb.ATTN_NAMES:
        _close(grads[n], ref_g[n], dtype, n)


def _backbone_grads_jax(x, ws, cot, jdt):
    wt = tuple(jnp.asarray(ws[n], jnp.float32 if n.startswith("ln") else jdt)
               for n in fb.WEIGHT_NAMES)

    def loss(xx, ww):
        out = jfb.fused_backbone(xx, ww, HEADS, EPS, 2, True, 2)
        return jnp.sum(out.astype(jnp.float32) * cot)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt), wt)


def _backbone_grads_port(x, ws, cot, tdt, fast):
    xt = _t(x, tdt).requires_grad_(True)
    wt = tuple(_t(ws[n], torch.float32 if n.startswith("ln") else tdt).requires_grad_(True)
               for n in fb.WEIGHT_NAMES)
    out = fb.fused_backbone(xt, wt, HEADS, EPS, fast_gelu=fast)
    (out.float() * _t(cot)).sum().backward()
    return xt.grad, tuple(w.grad for w in wt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_grads_match_jax_grad(dtype):
    """dx and all 12 stacked weight gradients of the whole backbone, in the
    weights' own dtypes (bf16 matmul weights and biases, fp32 LN params)
    under bf16, against jax.grad through the Pallas kernels in interpret
    mode (exact gelu: tests/conftest.py pins it)."""
    rng, ws = _weights(2)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    jdt, tdt = (BF16 if dtype == "bfloat16" else F32).values()
    ref_dx, ref_dw = _backbone_grads_jax(x, ws, cot, jdt)
    dx, dw = _backbone_grads_port(x, ws, cot, tdt, fast=False)
    assert dx.dtype == tdt
    _close(dx.float(), ref_dx.astype(jnp.float32), dtype, "dx")
    for n, got, ref in zip(fb.WEIGHT_NAMES, dw, ref_dw):
        assert got.dtype == (torch.float32 if n.startswith("ln") else tdt), n
        _close(got.float(), ref.astype(jnp.float32), dtype, n)


@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
def test_function_matches_autograd_of_plain_forward(fast):
    """fp32: the Function's hand-written backward against torch autograd
    through `backbone_forward_plain`. Exact gelu: float32 reassociation,
    1e-4. Fast gelu: the backward uses the fitted gelu' rational (|err|
    4.6e-5 against the true derivative, as the Pallas kernels do) where
    autograd differentiates the forward rational, 1e-3 on gradients up
    to ~7."""
    rng, ws = _weights(3, layers=3)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    dx, dw = _backbone_grads_port(x, ws, cot, torch.float32, fast)
    xt = _t(x).requires_grad_(True)
    wt = tuple(_t(ws[n]).requires_grad_(True) for n in fb.WEIGHT_NAMES)
    out = fb.backbone_forward_plain(xt, wt, HEADS, EPS, fast)
    (out * _t(cot)).sum().backward()
    tol = 1e-3 if fast else 1e-4
    torch.testing.assert_close(dx, xt.grad, atol=tol, rtol=1e-4)
    for n, got, w in zip(fb.WEIGHT_NAMES, dw, wt):
        torch.testing.assert_close(got, w.grad, atol=tol, rtol=1e-4, msg=n)


def test_backward_twin_equals_function_backward():
    """`backbone_backward_plain` (chip_smoke's reference for the kernels'
    12-layer backward) is the Function's backward on the CPU, bit for bit."""
    rng, ws = _weights(4)
    x = _t(rng.standard_normal((B, S, D)), torch.bfloat16)
    wt = tuple(_t(ws[n], torch.float32 if n.startswith("ln") else torch.bfloat16)
               for n in fb.WEIGHT_NAMES)
    cot = _t(rng.standard_normal((B, S, D)) * 0.1, torch.bfloat16)
    out, xs, x2s = fb.fused_backbone(x, wt, HEADS, EPS, fast_gelu=True, emit_res=True)
    dx, dw = fb.backbone_backward_plain(xs, x2s, cot, wt, HEADS, EPS, True)
    xg = x.clone().requires_grad_(True)
    wg = tuple(w.clone().requires_grad_(True) for w in wt)
    out2 = fb.fused_backbone(xg, wg, HEADS, EPS, fast_gelu=True)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    out2.backward(cot)
    torch.testing.assert_close(xg.grad, dx, rtol=0, atol=0)
    for got, ref, w in zip(wg, dw, wt):
        torch.testing.assert_close(got.grad, ref.to(w.dtype), rtol=0, atol=0)


def test_gelu_grad_forms_match_jax():
    xs = np.linspace(-8.0, 8.0, 4001).astype(np.float32)
    xt = torch.from_numpy(xs)
    for fast, ref in ((False, jfb._gelu_grad_exact), (True, jfb._gelu_grad_fast)):
        np.testing.assert_allclose(fb.gelu_grad(xt, fast).numpy(),
                                   np.asarray(ref(jnp.asarray(xs))), atol=1e-6)
    # both are the derivative of their gelu: central differences, fp64
    x64 = torch.linspace(-6.0, 6.0, 1201, dtype=torch.float64)
    h = 1e-4
    for fast in (False, True):
        num = (fb.gelu(x64 + h, fast) - fb.gelu(x64 - h, fast)) / (2 * h)
        assert float((fb.gelu_grad(x64, fast) - num).abs().max()) < 1e-4


def test_no_grad_forward_keeps_no_residuals():
    """Under no_grad (the target nets, serving) the forward does not go
    through the Function: the output carries no graph."""
    rng, ws = _weights(5)
    x = _t(rng.standard_normal((B, S, D))).requires_grad_(True)
    wt = tuple(_t(ws[n]) for n in fb.WEIGHT_NAMES)
    with torch.no_grad():
        out = fb.fused_backbone(x, wt, HEADS, EPS, fast_gelu=False)
    assert out.grad_fn is None
    out = fb.fused_backbone(x, wt, HEADS, EPS, fast_gelu=False)
    assert type(out.grad_fn).__name__ == "_FusedBackboneBackward"


def test_cpu_backward_counts_no_kernel_launches():
    rng, ws = _weights(6)
    before = (fb.fused_backbone.launches, fb.mlp_bwd.launches, fb.attn_bwd.launches)
    _backbone_grads_port(rng.standard_normal((B, S, D)).astype(np.float32), ws,
                         np.ones((B, S, D), np.float32), torch.float32, fast=True)
    assert (fb.fused_backbone.launches, fb.mlp_bwd.launches,
            fb.attn_bwd.launches) == before


def test_backward_kernel_input_checks():
    """What the CUDA backward kernels do not take is refused before any
    launch (plain Python checks, so they run here)."""
    shapes = {n: s[1:] for n, s in fb._weight_shapes(1, 128, 256).items()}
    w = {n: torch.zeros(s, dtype=torch.float32 if n.startswith("ln") else torch.bfloat16)
         for n, s in shapes.items()}
    out = {n: torch.zeros(s) for n, s in shapes.items()}
    x = torch.zeros((2, 9, 128), dtype=torch.bfloat16)
    fb._check_layer_inputs(x, x, w, fb.MLP_NAMES, None, out)
    fb._check_layer_inputs(x, x, w, fb.ATTN_NAMES, 2, out)
    fb._check_layer_inputs(x, x, w, fb.ATTN_NAMES, 4, out)  # head_dim 32: the general route
    with pytest.raises(ValueError, match="head_dim"):
        fb._check_layer_inputs(x, x, w, fb.ATTN_NAMES, 1, out)
    with pytest.raises(ValueError, match="incoming gradient"):
        fb._check_layer_inputs(x, x.float(), w, fb.MLP_NAMES, None, out)
    # fp32 activations with fp32 weights take the kernels' fp32 route
    # (compute_dtype=float32, as the Pallas bodies take any dtype); fp16, or
    # fp32 activations with bf16 weights, are refused
    w32 = {n: t.float() for n, t in w.items()}
    fb._check_layer_inputs(x.float(), x.float(), w32, fb.MLP_NAMES, None, out)
    fb._check_layer_inputs(x.float(), x.float(), w32, fb.ATTN_NAMES, 2, out)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fb._check_layer_inputs(x.half(), x.half(), w, fb.MLP_NAMES, None, out)
    with pytest.raises(TypeError, match="w1: expected torch.float32"):
        fb._check_layer_inputs(x.float(), x.float(), w, fb.MLP_NAMES, None, out)
    bad = dict(w, w2=w["w2"].float())
    with pytest.raises(TypeError, match="w2"):
        fb._check_layer_inputs(x, x, bad, fb.MLP_NAMES, None, out)
    with pytest.raises(ValueError, match="gradient output wo"):
        fb._check_layer_inputs(x, x, w, fb.ATTN_NAMES, 2, dict(out, wo=out["wo"].t()))
    # above 256 tokens bf16 and fp32 take the long-sequence routes
    xl = torch.zeros((1, fb.KERNEL_MAX_SEQ + 1, 128), dtype=torch.bfloat16)
    fb._check_layer_inputs(xl, xl, w, fb.ATTN_NAMES, 2, out)
    fb._check_layer_inputs(xl.float(), xl.float(), w32, fb.ATTN_NAMES, 2, out)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fb.mlp_bwd(x.to("meta"), x.to("meta"), w, EPS, True)
