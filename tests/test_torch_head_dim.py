"""head_dim 16, 32 and 48 (D 32, 64 and 96 at 2 heads): the port's plain
twins of every kernel against the JAX package's Pallas bodies in interpret
mode on the CPU, and the geometry predicate that picks a kernel route.

On the card these geometries take the kernels' general route
(ops/fused_block.py geometry_route: the seven-launch forward layer, the
backward sequences, the attention kernels instantiated on the head_dim),
which chip_smoke.py phase 17 holds against the same twins up to 256 tokens
(above them tests/test_torch_general_long.py and phase 19). Here the
wrappers run the twins. Inputs and weights come from numpy with a seed
and go to both sides.

Each body is held at every head_dim in both dtypes and at both S (5: one
16-row tile with 11 pad rows; 50: four tiles), over the cases of `CASES`
(the head_dim-32, S = 5 cases in both dtypes are
tests/test_torch_fused_block.py's, test_torch_backward.py's and
test_torch_fused_layer.py's). Tolerances are
those of the files that hold the same body at head_dim 64 or 32:
  * the backbone forward: fp32 1e-5 absolute (test_emit_res_matches_pallas),
    bf16 3e-2 absolute and 2e-2 relative (test_plain_backbone_matches_pallas_bf16);
  * one layer forward and backward (fused_block, the merged backward):
    test_torch_fused_layer.py's TOL, fp32 5e-6 forward and 2e-4 gradients,
    bf16 4% largest and 0.5% mean error of the largest magnitude;
  * the flash pair: test_torch_flash_attention.py's, fp32 2e-5 forward and
    5e-5 gradients, bf16 1% largest and 0.1% mean error of the largest
    magnitude."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.ops.flash_attention import mha_pallas as jax_mha_pallas
from vit2spn_tpu_torch.core.config import ViTConfig
from vit2spn_tpu_torch.evals.parity import runbook_attn_impl, smoke_vit_config
from vit2spn_tpu_torch.ops import flash_attention as fa
from vit2spn_tpu_torch.ops import fused_block as fb

# the module, not the `fused_block` function vit2spn_tpu.ops exports
jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

HEADS, B, L = 2, 2, 2
EPS = 1e-12
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (head_dim, S, dtype): every head_dim in both dtypes and at both S, with
# the head_dim-32, S = 5 cases of the files named above
CASES = [(16, 5, "bfloat16"), (16, 50, "float32"), (32, 50, "bfloat16"),
         (48, 5, "float32"), (48, 50, "bfloat16")]
IDS = [f"dh{dh}_s{s}_{dt[:4]}" for dh, s, dt in CASES]
LAYER_TOL = {"float32": (5e-6, 2e-4), "bfloat16": (4e-2, 5e-3)}


def _weights(seed, d, layers=None, std=0.1):
    """Block weights (stacked over `layers`, else one layer's) with nonzero
    biases and LN params, mlp 2 D, Wqkv, Wo and W2 of `std` (0.05 for the
    backbone, as tests/test_torch_fused_block.py draws them); W1 large
    enough that the gelu forms differ."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    mlp = 2 * d

    def n(*shape, std):
        return (rng.standard_normal(lead + shape) * std).astype(np.float32)

    ws = {
        "ln1_scale": 1.0 + n(d, std=0.1), "ln1_bias": n(d, std=0.1),
        "wqkv": n(d, 3 * d, std=std), "bqkv": n(3 * d, std=0.05),
        "wo": n(d, d, std=std), "bo": n(d, std=0.05),
        "ln2_scale": 1.0 + n(d, std=0.1), "ln2_bias": n(d, std=0.1),
        "w1": n(d, mlp, std=0.4), "b1": n(mlp, std=0.05),
        "w2": n(mlp, d, std=std), "b2": n(d, std=0.05),
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


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, ref, what, max_tol, mean_tol):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    mx = float(np.abs(ref).max()) or 1.0
    err = np.abs(got - ref)
    assert err.max() <= max_tol * mx, (what, float(err.max()), mx)
    assert err.mean() <= mean_tol * mx, (what, float(err.mean()), mx)


def _layer_close(got, ref, dtype, what, grad=False):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=LAYER_TOL[dtype][grad],
                                   rtol=1e-4, err_msg=what)
    else:
        _rel(got, ref, what, *LAYER_TOL[dtype])


@pytest.mark.parametrize("dh, s, dtype", CASES, ids=IDS)
def test_backbone_with_its_stacks_matches_pallas(dh, s, dtype):
    """fused_backbone with `emit_res` (out, xs, x2s) against
    `_backbone_fwd_impl(emit_res=True)` in interpret mode, whose outputs are
    seq-padded to 16: the first S rows are compared."""
    d = HEADS * dh
    rng, ws = _weights(dh + s, d, layers=L, std=0.05)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(ws, jdt, tdt)
    ref = jfb._backbone_fwd_impl(jnp.asarray(x, jdt), jw, HEADS, EPS, 2, True, emit_res=True)
    got = fb.fused_backbone(torch.from_numpy(x).to(tdt), tw, HEADS, EPS, fast_gelu=False,
                            emit_res=True)
    assert got[1].shape == got[2].shape == (L, B, s, d)
    for name, a, r in zip(("out", "xs", "x2s"), got, ref):
        assert a.dtype == tdt, name
        r = _f32(r)[:, :s] if name == "out" else _f32(r)[:, :, :s]
        if dtype == "float32":
            np.testing.assert_allclose(_f32(a), r, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(_f32(a), r, atol=3e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("dh, s, dtype", CASES, ids=IDS)
def test_fused_block_matches_pallas(dh, s, dtype):
    """One layer, `fused_block`: the output (`_fwd_kernel`), dx and the 12
    weight gradients (its custom_vjp: the split backward bodies) for the
    loss sum(out * cot), against the JAX fused_block in interpret mode."""
    d = HEADS * dh
    rng, ws = _weights(100 + dh + s, d)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    cot = (rng.standard_normal((B, s, d)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(ws, jdt, tdt)

    def loss(xx, ww):
        out = jfb.fused_block(xx, ww, HEADS, EPS, 2, True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, ref), (ref_dx, ref_dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jdt), jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = tuple(t.requires_grad_(True) for t in tw)
    out = fb.fused_block(xt, wt, HEADS, EPS, fast_gelu=False)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tdt and xt.grad.dtype == tdt
    _layer_close(out, ref, dtype, "out")
    _layer_close(xt.grad, ref_dx, dtype, "dx", True)
    for n, w, r in zip(fb.WEIGHT_NAMES, wt, ref_dw):
        assert w.grad.dtype == w.dtype, n
        _layer_close(w.grad, r, dtype, n, True)


@pytest.mark.parametrize("dh, s, dtype", CASES, ids=IDS)
def test_merged_bwd_matches_pallas(dh, s, dtype):
    """The merged backward's twin (`merged_bwd_plain`, through the wrapper)
    against `_layer_bwd(merged=True)`: `_merged_bwd_kernel` in interpret
    mode on seq-padded tensors, dx and the 12 weight gradients."""
    d, sp = HEADS * dh, (s + 15) // 16 * 16
    rng, ws = _weights(200 + dh + s, d)
    x, x2 = (rng.standard_normal((B, s, d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((B, s, d))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw = {n: t for n, t in zip(fb.WEIGHT_NAMES, _typed(ws, jdt, tdt)[0])}
    tw = {n: t for n, t in zip(fb.WEIGHT_NAMES, _typed(ws, jdt, tdt)[1])}

    def pad(a):
        return jnp.pad(jnp.asarray(a, jdt), ((0, 0), (0, sp - s), (0, 0)))

    ref_dx, ref_g = jfb._layer_bwd(pad(x), pad(x2), pad(g), jw, HEADS, s, sp, EPS, 2, True,
                                   merged=True)
    t = [torch.from_numpy(a).to(tdt) for a in (x, x2, g)]
    dx, grads = fb.merged_bwd(*t, tw, HEADS, EPS, False)
    assert dx.dtype == tdt
    _layer_close(dx, _f32(ref_dx)[:, :s], dtype, "dx", True)
    for n in fb.WEIGHT_NAMES:
        assert grads[n].dtype == torch.float32
        _layer_close(grads[n], _f32(ref_g[n]).reshape(ws[n].shape), dtype, n, True)


@pytest.mark.parametrize("dh, s, dtype", CASES, ids=IDS)
def test_mha_pallas_matches_pallas(dh, s, dtype):
    """`mha_pallas`: the forward and (dq, dk, dv) for the loss sum(out *
    cot) against the JAX mha_pallas with its flash kernels in interpret
    mode."""
    shape = (B, s, HEADS, dh)
    rng = np.random.default_rng(300 + dh + s)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    jdt, tdt = DTYPES[dtype]

    def loss(*a):
        out = jax_mha_pallas(*a, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, ref), ref_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t, jdt) for t in (q, k, v)))
    args = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in (q, k, v)]
    out = fa.mha_pallas(*args)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tdt
    for name, a, r, tol in [("out", out, ref, 2e-5)] + [
            (f"d{n}", t.grad, rg, 5e-5) for n, t, rg in zip("qkv", args, ref_g)]:
        if dtype == "float32":
            np.testing.assert_allclose(_f32(a), _f32(r), atol=tol, rtol=0, err_msg=name)
        else:
            _rel(a, r, name, 1e-2, 1e-3)


# ---------------------------------------------------------------------------
# The geometry predicate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d, heads, mlp, s, route", [
    (32, 2, 64, 5, "general"),      # the tiny model: head_dim 16
    (64, 2, 256, 197, "general"),   # head_dim 32
    (96, 2, 384, 256, "general"),   # head_dim 48 at the longest S of the route
    (192, 6, 768, 197, "general"),  # ViT-Tiny's width at 6 heads
    (64, 1, 96, 50, "general"),     # head_dim 64 with mlp a multiple of 32 only
    (192, 3, 768, 577, "fast"),     # ViT-Tiny at 384 px: every route of before
    (768, 12, 3072, 577, "fast"),
    (96, 2, None, 256, "general"),  # the attention kernels: no mlp
    (96, None, 384, 5000, "general"),  # the MLP half: no attention, any S
    # above 256 tokens the general route's multi-pass attention kernels
    (32, 2, 64, 257, "general"),    # the tiny model at 256 px
    (64, 1, 96, 300, "general"),    # head_dim 64 with mlp 96: the head_dim-64 long routes
    # head_dim 80 (ViT-Huge/14) at any S: the multi-pass kernels at every S
    (160, 2, 640, 5, "general"),
    (160, 2, 640, 577, "general"),
    (1056, 33, 4224, 5, "general"),  # head_dim 32 at a D between 1024 and 1280
], ids=["dh16", "dh32", "dh48_s256", "tiny_width_6_heads", "dh64_mlp96", "tiny_384px",
        "base_384px", "no_mlp", "no_heads", "s257_dh16", "mlp96_s300", "dh80", "dh80_s577",
        "d1056"])
def test_geometry_route_accepts(d, heads, mlp, s, route):
    assert fb.geometry_route(d, heads, mlp, s) == (route, "")
    assert fb.check_geometry(d, heads, mlp, s) == route


@pytest.mark.parametrize("d, heads, mlp, s, message", [
    (192, 2, 768, 5, "head_dim in (16, 32, 48, 64, 80); got D=192, heads=2"),
    (48, 1, 192, 5, "D a multiple of 32 with D <= 1280, got D=48"),
    # past the widest LayerNorm row, ViT-Huge's D = 1280 (which the kernels take)
    (1312, 41, 5248, 5, "D <= 1280, got D=1312"),
    (64, 2, 80, 5, "mlp a multiple of 32, got 80"),
    (96, 5, 384, 5, "head_dim in"),
    # above 256 tokens the same refusals hold (S bounds only the bf16 core:
    # check_seq_len)
    (192, 2, 768, 577, "head_dim in (16, 32, 48, 64, 80); got D=192, heads=2"),
    (64, 2, 80, 257, "mlp a multiple of 32, got 80"),
    (32, 2, 64, 0, "S >= 1, got S=0"),  # as csrc/common.cuh geometry_ok
], ids=["dh96", "d48", "d1280", "mlp80", "heads_not_dividing", "dh96_s577", "mlp80_s257",
        "s0"])
def test_geometry_route_refuses_with_its_reason(d, heads, mlp, s, message):
    route, why = fb.geometry_route(d, heads, mlp, s)
    assert route is None and message in why
    with pytest.raises(ValueError, match="refuses this geometry"):
        fb.check_geometry(d, heads, mlp, s)


def test_wrappers_check_the_geometry_before_any_launch():
    """The wrappers' checks are the predicate's: the tiny model's operands
    pass, at S = 257 too (the multi-pass routes), head_dim 96 is refused
    with its message, and S above LONG_CORE_MAX_SEQ at head_dim 16 by the
    layer backwards' check in bf16 (plain Python, so they run here)."""
    shapes = fb._weight_shapes(L, 32, 64)
    wt = tuple(torch.zeros(shapes[n], dtype=torch.float32 if n.startswith("ln")
                           else torch.bfloat16) for n in fb.WEIGHT_NAMES)
    x = torch.zeros((2, 5, 32), dtype=torch.bfloat16)
    fb._check_kernel_inputs(x, wt, 2)
    fb._check_kernel_inputs(torch.zeros((1, 257, 32), dtype=torch.bfloat16), wt, 2)
    limit = fb.LONG_CORE_MAX_SEQ
    x = torch.zeros((1, limit + 1, 32), dtype=torch.bfloat16)
    fb._check_activation(x, 2)  # the forward's: any S
    fb._check_activation(x.float(), 2, core=True)  # the fp32 backwards': any S
    with pytest.raises(ValueError, match=f"S <= {limit} in bf16"):
        fb._check_layer_inputs(x, x, {}, fb.ATTN_NAMES, 2, {})
    shapes = fb._weight_shapes(L, 192, 768)
    wt = tuple(torch.zeros(shapes[n], dtype=torch.float32 if n.startswith("ln")
                           else torch.bfloat16) for n in fb.WEIGHT_NAMES)
    with pytest.raises(ValueError, match="head_dim in"):
        fb._check_kernel_inputs(torch.zeros((2, 5, 192), dtype=torch.bfloat16), wt, 2)
    q = torch.zeros((2, 5, 2, 16), dtype=torch.bfloat16)
    fa._check_flash_inputs(q, q, q)
    q = torch.zeros((2, 257, 2, 16), dtype=torch.bfloat16)
    fa._check_flash_inputs(q, q, q)


@pytest.mark.parametrize("s", [197, 577])
def test_flash_checks_take_any_number_of_heads_at_head_dim_64(s):
    """The flash pair normalises no row of D values, so the LayerNorm's
    D <= 1280 does not bound it: 21 heads of 64 (D 1344) pass its checks at
    any S, as the C entry takes them; the layer kernels refuse that D."""
    q = torch.zeros((2, s, 21, 64), dtype=torch.bfloat16)
    fa._check_flash_inputs(q, q, q)
    fa._check_flash_inputs(q.float(), q.float(), q.float())
    assert fb.geometry_route(1344, 21, None, s, layernorm=False) == ("fast", "")
    route, why = fb.geometry_route(1344, 21, None, s)
    assert route is None and "D <= 1280" in why


def test_runbook_takes_the_kernels_where_the_predicate_does():
    """The parity runbook's path on CUDA follows the predicate: the smoke
    geometry (head_dim 16) takes "fused", head_dim 80 too, head_dim 96 "xla"."""
    smoke = smoke_vit_config()
    assert (smoke.head_dim, smoke.seq_len) == (16, 5)
    assert runbook_attn_impl(smoke, "cuda") == "fused"
    assert runbook_attn_impl(ViTConfig(hidden_size=160, num_heads=2, mlp_dim=640),
                             "cuda") == "fused"
    assert runbook_attn_impl(ViTConfig(hidden_size=192, num_heads=2, mlp_dim=768),
                             "cuda") == "xla"
    assert runbook_attn_impl(ViTConfig(num_heads=6), "cuda") == "fused"
    # head_dim 16 above 256 tokens: the general route's multi-pass kernels
    assert runbook_attn_impl(ViTConfig(image_size=384, hidden_size=32, num_heads=2,
                                       mlp_dim=64), "cuda") == "fused"
