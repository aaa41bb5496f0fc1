"""The port's per-layer fused path and merged backward
(vit2spn_tpu_torch/ops/fused_block.py: `fused_block`, `layer_forward_plain`,
`merged_bwd_plain`; models/vit.py under attn_impl="fused_layer") against the
JAX package's Pallas kernels in interpret mode on the CPU.

On the CPU the wrappers run the kernels' plain twins; the CUDA kernels
(csrc/layer_fwd.cu, csrc/merged_bwd.cu) are held against the twins on the
card by chip_smoke.py. Inputs come from numpy with a seed and go to both
sides. Tolerances, as tests/test_torch_backward.py states them: fp32 is
float32 reassociation only; bf16 rounds at the same points on both sides but
sums in other orders, so one bf16 step can separate them."""

import importlib

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
from vit2spn_tpu_torch.ops import fused_block as fb

# the module, not the `fused_block` function vit2spn_tpu.ops exports
jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

D, HEADS, MLP, S, B = 64, 2, 128, 5, 3
EPS = 1e-12
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (forward atol, gradient atol) in fp32; (largest, mean) error relative to
# the largest magnitude in bf16
TOL = {"float32": (5e-6, 2e-4), "bfloat16": (4e-2, 5e-3)}


def _weights(seed, layers=None):
    """One layer's (or `layers` stacked) block weights, nonzero biases and LN
    params; W1 large enough that the gelu forms differ."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)

    def n(*shape, std):
        return (rng.standard_normal(lead + shape) * std).astype(np.float32)

    ws = {
        "ln1_scale": 1.0 + n(D, std=0.1), "ln1_bias": n(D, std=0.1),
        "wqkv": n(D, 3 * D, std=0.1), "bqkv": n(3 * D, std=0.05),
        "wo": n(D, D, std=0.1), "bo": n(D, std=0.05),
        "ln2_scale": 1.0 + n(D, std=0.1), "ln2_bias": n(D, std=0.1),
        "w1": n(D, MLP, std=0.4), "b1": n(MLP, std=0.05),
        "w2": n(MLP, D, std=0.1), "b2": n(D, std=0.05),
    }
    return rng, ws


def _typed(ws, jdt, tdt):
    """(jax tuple, torch tuple) in WEIGHT_NAMES order: LN params fp32, the
    rest in the compute dtype."""
    j = tuple(jnp.asarray(ws[n], jnp.float32 if n.startswith("ln") else jdt)
              for n in fb.WEIGHT_NAMES)
    t = tuple(torch.from_numpy(ws[n]).to(torch.float32 if n.startswith("ln") else tdt)
              for n in fb.WEIGHT_NAMES)
    return j, t


def _close(got, ref, dtype, what, grad=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL[dtype][grad], rtol=1e-4, err_msg=what)
    else:
        mx = float(np.abs(ref).max()) or 1.0
        err = np.abs(got - ref)
        assert err.max() <= TOL[dtype][0] * mx, (what, float(err.max()), mx)
        assert err.mean() <= TOL[dtype][1] * mx, (what, float(err.mean()), mx)


@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_matches_jax(dtype, fast, monkeypatch):
    """Output, dx and the 12 weight gradients (in the weights' own dtypes)
    of one block, for the loss sum(out * cot)."""
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    rng, ws = _weights(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(ws, jdt, tdt)

    def loss(xx, ww):
        out = jfb.fused_block(xx, ww, HEADS, EPS, 2, True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, ref), (ref_dx, ref_dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jdt), jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = tuple(t.requires_grad_(True) for t in tw)
    out = fb.fused_block(xt, wt, HEADS, EPS, fast_gelu=fast)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tdt and xt.grad.dtype == tdt
    _close(out.detach().float(), jnp.asarray(ref).astype(jnp.float32), dtype, "out")
    _close(xt.grad.float(), jnp.asarray(ref_dx).astype(jnp.float32), dtype, "dx", True)
    for n, w, r in zip(fb.WEIGHT_NAMES, wt, ref_dw):
        assert w.grad.dtype == w.dtype, n
        _close(w.grad.float(), jnp.asarray(r).astype(jnp.float32), dtype, n, True)


def test_layer_forward_plain_is_one_layer_of_the_backbone_twin():
    """`layer_forward_plain` (the twin of csrc/layer_fwd.cu) run over each
    layer gives `backbone_forward_plain`'s output and residual stacks bit for
    bit, as the two kernels share their layer code."""
    rng, ws = _weights(1, layers=3)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32)).to(torch.bfloat16)
    _, wt = _typed(ws, jnp.bfloat16, torch.bfloat16)
    out, xs, x2s = fb.backbone_forward_plain(x, wt, HEADS, EPS, True, emit_res=True)
    h = x
    for l in range(3):
        torch.testing.assert_close(h, xs[l], rtol=0, atol=0)
        h, x2 = fb.layer_forward_plain(h, tuple(t[l] for t in wt), HEADS, EPS, True)
        assert x2.dtype == torch.bfloat16
        torch.testing.assert_close(x2, x2s[l], rtol=0, atol=0)
    torch.testing.assert_close(h, out, rtol=0, atol=0)


def test_fused_layer_vit_matches_jax_layer_loop(monkeypatch):
    """attn_impl="fused_layer": the port's loop of `fused_block` against the
    JAX vit_forward's lax.scan over `fused_block` in interpret mode (exact
    gelu, tests/conftest.py pins it), fp32."""
    cfg = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=2,
               mlp_dim=128)
    p = jax.device_get(jvit.init_vit(jax.random.key(7), JViTConfig(**cfg)))
    rng = np.random.default_rng(7)
    for name in ("bqkv", "bo", "b1", "b2", "ln1_bias", "ln2_bias"):
        p["blocks"][name] = (0.05 * rng.standard_normal(p["blocks"][name].shape)
                             ).astype(np.float32)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    real = jfb.fused_block
    monkeypatch.setattr(jfb, "fused_block",
                        lambda xx, wt, heads, eps: real(xx, wt, heads, eps, 2, True))
    ref = jvit.vit_forward(p, jnp.asarray(x), JViTConfig(**cfg), JFP32, "fused_layer")
    tp = from_jax(p, device="cpu")
    got = tvit.vit_forward(tp, torch.from_numpy(x), ViTConfig(**cfg), FP32, "fused_layer",
                           fast_gelu=False)
    for key in ("pre_ln", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=2e-5,
                                   rtol=0, err_msg=key)
    # on the CPU the per-layer loop is the whole-backbone twin, bit for bit
    fused = tvit.vit_forward(tp, torch.from_numpy(x), ViTConfig(**cfg), FP32, "fused",
                             fast_gelu=False)
    torch.testing.assert_close(got["pre_ln"], fused["pre_ln"], rtol=0, atol=0)


@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
def test_merged_bwd_plain_is_the_split_twins(fast):
    rng, ws = _weights(2)
    _, tw = _typed(ws, jnp.bfloat16, torch.bfloat16)
    w = dict(zip(fb.WEIGHT_NAMES, tw))
    x, x2, dout = (torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32) * s
                                    ).to(torch.bfloat16) for s in (1.0, 1.0, 0.1))
    dx, grads = fb.merged_bwd_plain(x, x2, dout, w, HEADS, EPS, fast)
    dx2, mlp_grads = fb.mlp_bwd_plain(x2, dout, w, EPS, fast)
    ref_dx, attn_grads = fb.attn_bwd_plain(x, dx2, w, HEADS, EPS)
    torch.testing.assert_close(dx, ref_dx, rtol=0, atol=0)
    assert sorted(grads) == sorted(fb.WEIGHT_NAMES)
    for n, g in {**mlp_grads, **attn_grads}.items():
        torch.testing.assert_close(grads[n], g, rtol=0, atol=0, msg=n)
    # the wrapper on CPU tensors is the twin, and counts no launch
    before = fb.merged_bwd.launches
    out = {n: torch.empty(t.shape) for n, t in w.items()}
    got_dx, got = fb.merged_bwd(x, x2, dout, w, HEADS, EPS, fast, out)
    assert got is out and fb.merged_bwd.launches == before
    torch.testing.assert_close(got_dx, dx, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_backbone_grads_match_jax(dtype, monkeypatch):
    """VIT2SPN_MERGED_BWD=1 on both sides: the port's fused_backbone
    gradients (its Function running merged_bwd per layer) against jax.grad of
    the JAX fused_backbone, whose backward runs _merged_bwd_kernel in
    interpret mode."""
    monkeypatch.setenv("VIT2SPN_MERGED_BWD", "1")
    rng, ws = _weights(3, layers=2)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(ws, jdt, tdt)

    def loss(xx, ww):
        out = jfb.fused_backbone(xx, ww, HEADS, EPS, 2, True, 2)
        return jnp.sum(out.astype(jnp.float32) * cot)

    ref_dx, ref_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt), jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = tuple(t.requires_grad_(True) for t in tw)
    before = (fb.merged_bwd.launches, fb.mlp_bwd.launches, fb.attn_bwd.launches)
    out = fb.fused_backbone(xt, wt, HEADS, EPS, fast_gelu=False)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert (fb.merged_bwd.launches, fb.mlp_bwd.launches, fb.attn_bwd.launches) == before
    _close(xt.grad.float(), jnp.asarray(ref_dx).astype(jnp.float32), dtype, "dx", True)
    for n, w, r in zip(fb.WEIGHT_NAMES, wt, ref_dw):
        assert w.grad.dtype == w.dtype, n
        _close(w.grad.float(), jnp.asarray(r).astype(jnp.float32), dtype, n, True)


def test_merged_backward_is_read_at_each_call(monkeypatch):
    """The variable is read when the backward runs, not when the forward
    ran: one graph, backward under each setting, the same bits on the CPU
    (the merged twin is the split twins in a row)."""
    rng, ws = _weights(4, layers=2)
    _, tw = _typed(ws, jnp.bfloat16, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32)).to(torch.bfloat16)
    grads = []
    for merged in ("0", "1"):
        wt = tuple(t.clone().requires_grad_(True) for t in tw)
        out = fb.fused_backbone(x, wt, HEADS, EPS, fast_gelu=True)
        monkeypatch.setenv("VIT2SPN_MERGED_BWD", merged)
        assert fb.merged_bwd_enabled() is (merged == "1")
        out.float().sum().backward()
        grads.append([w.grad for w in wt])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layer_kernel_input_checks():
    """What csrc/layer_fwd.cu and csrc/merged_bwd.cu do not take is refused
    before any launch (plain Python checks, so they run here)."""
    shapes = {n: s[1:] for n, s in fb._weight_shapes(1, 128, 256).items()}
    wt = tuple(torch.zeros(shapes[n], dtype=torch.float32 if n.startswith("ln")
                           else torch.bfloat16) for n in fb.WEIGHT_NAMES)
    x = torch.zeros((2, 9, 128), dtype=torch.bfloat16)
    fb._check_kernel_inputs(x, wt, 2, stacked=False)
    with pytest.raises(ValueError, match="expected shape"):
        fb._check_kernel_inputs(x, wt, 2)  # stacked shapes expected
    # fp32 activations with fp32 weights: the fp32 route; fp16, or fp32
    # activations with bf16 weights, are refused
    fb._check_kernel_inputs(x.float(), tuple(t.float() for t in wt), 2, stacked=False)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fb._check_kernel_inputs(x.half(), wt, 2, stacked=False)
    with pytest.raises(TypeError, match="wqkv: expected torch.float32"):
        fb._check_kernel_inputs(x.float(), wt, 2, stacked=False)
    with pytest.raises(ValueError, match="head_dim"):
        fb._check_kernel_inputs(x, wt, 4, stacked=False)
    m = torch.zeros((2, 9, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fb.layer_fwd(m, wt, 2, EPS, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fb.merged_bwd(m, m, m, dict(zip(fb.WEIGHT_NAMES, wt)), 2, EPS, True)
