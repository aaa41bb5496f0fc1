"""ViT-Huge/14 on the CPU: head_dim 80 and D = 1280, the widest geometry the
port's kernels take, against the JAX package.

On the CPU every wrapper runs its plain twin, which takes any geometry; on
the card head_dim 80 takes csrc/general_long.cuh's streamed attention
kernels at every S (bf16) and csrc/flash_f32.cuh's multi-pass route (fp32),
and D = 1280 the LayerNorm rows at 40 values a lane, held against the same
twins by chip_smoke.py (phase 20). Here:

1. the ViT-Huge/14 dotted overrides (`-o vit.hidden_size=1280 -o
   vit.num_heads=16 -o vit.mlp_dim=5120 -o vit.num_layers=32 -o
   vit.patch_size=14`) give equal configs in both CLIs (S = 257 at 224 px);
2. `geometry_route`: head_dim 80 and D = 1280 are taken on ROUTE_GENERAL
   (D 1280 as 20 heads of 64 on ROUTE_FAST), head_dim 96 / 128 and D = 1312
   are refused with their reasons; the bf16 core's S limit at head_dim 80;
   the parity runbook keeps "fused" at ViT-Huge/14;
3. at head_dim 80 (D 160, 2 heads, mlp 320, 2 layers) at S = 17 and 257,
   fp32 and bf16, the twins against interpret-mode Pallas: the backbone
   forward with its xs / x2s stacks, `fused_block` (forward, dx and the
   weight gradients), the split and the merged layer backward, and
   `mha_pallas` with its gradients;
4. the streamed kernels' order of sums (tests/test_torch_general_long.py's
   emulations: the stage, the core, the flash pair in bf16, the fp32
   multi-pass route) at head_dim 80 and S = 17 and 257, which the card runs
   at every S, against interpret-mode Pallas;
5. one layer at ViT-Huge's width (D 1280, 16 heads, mlp 5120), B = 1, S =
   17: `fused_block` forward and gradients against the JAX `fused_block`;
6. models/convert.py and `.npz` checkpoints both ways at the D 160 head_dim
   80 geometry (patch 14, 224 px): the same features on both sides.

Inputs come from numpy with a seed and go to both sides. Tolerances are
tests/test_torch_long_seq.py's (fp32: float32 reassociation, atol 2e-5,
2e-4 for gradients, rtol 1e-4; bf16: both sides round at the same points
and sum in other orders, 4% of the largest magnitude, the mean 0.5%), the
flash pair tests/test_torch_flash_attention.py's, and at D = 1280
tests/test_torch_vit_large.py's (fp32 atol 2e-4, rtol 1e-4: longer sums
over K = 5120)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu import cli as jax_cli
from vit2spn_tpu.core.config import ViTConfig as JViTConfig
from vit2spn_tpu.core.dtypes import FP32 as JFP32
from vit2spn_tpu.core.presets import PRESETS as JAX_PRESETS
from vit2spn_tpu.models import vit as jvit
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu_torch import cli
from vit2spn_tpu_torch.core.config import ViTConfig
from vit2spn_tpu_torch.core.dtypes import FP32
from vit2spn_tpu_torch.core.presets import PRESETS
from vit2spn_tpu_torch.evals.parity import runbook_attn_impl
from vit2spn_tpu_torch.models import vit as tvit
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.ops import flash_attention as fa
from vit2spn_tpu_torch.ops import fused_block as fb
from vit2spn_tpu_torch.train import checkpoint as ckpt

from test_torch_general_long import (
    _gl_core,
    _gl_flash_bwd,
    _gl_flash_fwd,
    _gl_stage,
    _layer_bwd_ref,
    _multipass_f32,
)
from test_torch_long_seq import (
    _attention_operands,
    _close,
    _close_mha,
    _f32,
    _heads,
    _jax_mha,
    _port_mha,
    _tokens,
    _typed,
    _weights,
)

# the module, not the `fused_block` function vit2spn_tpu.ops exports
jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

HUGE = ("vit.hidden_size=1280", "vit.num_heads=16", "vit.mlp_dim=5120", "vit.num_layers=32",
        "vit.patch_size=14")
D, HEADS, MLP = 1280, 16, 5120
L, B = 2, 2
EPS = 1e-12
SEQS = [17, 257]
NARROW = (160, 2, 320)  # head_dim 80 at 2 heads
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WIDE_TOL = {"float32": (2e-4, None), "bfloat16": (4e-2, 5e-3)}


# ---------------------------------------------------------------------------
# 1. the overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["ssp-scratch", "ft-octmnist"])
def test_vit_huge_overrides_match_jax(preset):
    got = cli._apply_overrides(PRESETS[preset], list(HUGE))
    ref = jax_cli._apply_overrides(JAX_PRESETS[preset], list(HUGE))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    vit = got.vit
    assert (vit.hidden_size, vit.num_heads, vit.head_dim, vit.mlp_dim, vit.num_layers,
            vit.patch_size, vit.image_size, vit.seq_len) == (D, HEADS, 80, MLP, 32, 14, 224, 257)


# ---------------------------------------------------------------------------
# 2. the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d, heads, mlp, s, route", [
    (D, HEADS, MLP, 257, "general"),  # ViT-Huge/14 at 224 px
    (D, HEADS, MLP, 17, "general"),   # head_dim 80 below 256 tokens: the streamed kernels
    (160, 2, 320, 577, "general"),    # head_dim 80 at a narrow width, above 256 tokens
    (D, 20, MLP, 197, "fast"),        # D 1280 as 20 heads of 64: the widest LayerNorm row
    (D, 40, MLP, 197, "general"),     # head_dim 32 at D 1280
], ids=["huge_224px", "huge_s17", "dh80_d160_s577", "d1280_dh64", "d1280_dh32"])
def test_geometry_route_takes_vit_huge(d, heads, mlp, s, route):
    assert fb.geometry_route(d, heads, mlp, s) == (route, "")
    assert fb.check_geometry(d, heads, mlp, s) == route


@pytest.mark.parametrize("d, heads, mlp, message", [
    (768, 8, 3072, "head_dim in (16, 32, 48, 64, 80); got D=768, heads=8"),
    (1024, 8, 4096, "head_dim in (16, 32, 48, 64, 80); got D=1024, heads=8"),
    (1312, 41, 5248, "D a multiple of 32 with D <= 1280, got D=1312"),
], ids=["dh96", "dh128", "d1312"])
def test_geometry_route_refuses_past_vit_huge(d, heads, mlp, message):
    route, why = fb.geometry_route(d, heads, mlp, 257)
    assert route is None and message in why
    with pytest.raises(ValueError, match="refuses this geometry"):
        fb.check_geometry(d, heads, mlp, 257)


def test_core_seq_limit_at_head_dim_80():
    """The bf16 core at head_dim 80 keeps three fp32 statistics a query
    beside one tile slot and two ring stages, each two 64-row tiles of two
    8 KB slabs, and 1 KB to align them, in 232,448 - 256 bytes: (232,192 -
    99,328) / 12 bytes in whole 64-query chunks; at 16-64 the limit stays
    15,168. The wrappers' check refuses one query more before any launch;
    fp32 takes any S."""
    limit = fb.attention_core_max_seq(80)
    assert limit == (232448 - 256 - 1024 - 3 * 2 * 2 * 8192) // 12 // 64 * 64 == 11072
    assert [fb.attention_core_max_seq(dh) for dh in (16, 32, 48, 64)] == [15168] * 4
    fb.check_seq_len(limit, torch.bfloat16, "attention backward", core=True, head_dim=80)
    with pytest.raises(ValueError, match=f"takes S <= {limit} in bf16, got {limit + 1}"):
        fb.check_seq_len(limit + 1, torch.bfloat16, "attention backward", core=True,
                         head_dim=80)
    fb.check_seq_len(limit + 1, torch.bfloat16, "attention backward", core=True, head_dim=48)
    fb.check_seq_len(4 * limit, torch.float32, "attention backward", core=True, head_dim=80)
    x = torch.zeros(1, limit + 1, 160, dtype=torch.bfloat16)
    fb._check_activation(x, 2)  # the forward's: any S
    with pytest.raises(ValueError, match=f"S <= {limit} in bf16"):
        fb._check_layer_inputs(x, x, {}, fb.ATTN_NAMES, 2, {})


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_runbook_takes_the_kernels_at_vit_huge(dtype):
    vit = ViTConfig(hidden_size=D, num_heads=HEADS, mlp_dim=MLP, num_layers=32, patch_size=14)
    assert vit.seq_len == 257
    assert runbook_attn_impl(vit, "cuda", dtype) == "fused"
    # head_dim 96 still takes the per-op block on CUDA
    assert runbook_attn_impl(ViTConfig(hidden_size=768, num_heads=8, mlp_dim=3072), "cuda",
                             dtype) == "xla"


# ---------------------------------------------------------------------------
# 3. the twins against interpret-mode Pallas at head_dim 80
# ---------------------------------------------------------------------------

def _narrow_weights(seed, layers=None):
    """tests/test_torch_long_seq.py's block weights at D 160, the matrices'
    std scaled by 1 / sqrt(D / 64) (as tests/test_torch_vit_large.py), so
    the outputs keep the magnitudes of the narrower widths' cases."""
    d, _, mlp = NARROW
    rng, ws = _weights(seed, d, mlp, layers=layers)
    for n in ("wqkv", "wo", "w1", "w2"):
        ws[n] = (ws[n] * (64 / d) ** 0.5).astype(np.float32)
    return rng, ws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
def test_backbone_with_its_stacks_matches_pallas_at_head_dim_80(s, dtype):
    """`fused_backbone` (two layers) with `emit_res` against
    `_backbone_fwd_impl(emit_res=True)` in interpret mode (seq-padded to 16:
    the first S rows compared)."""
    d, heads, mlp = NARROW
    jdt, tdt = DTYPES[dtype]
    rng, ws = _narrow_weights(s + 80, layers=L)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    jw, tw = _typed(ws, jdt, tdt)
    ref = jfb._backbone_fwd_impl(jnp.asarray(x, jdt), jw, heads, EPS, 2, True, emit_res=True)
    got = fb.fused_backbone(torch.from_numpy(x).to(tdt), tw, heads, EPS, fast_gelu=False,
                            emit_res=True)
    assert got[1].shape == got[2].shape == (L, B, s, d)
    for name, a, r in zip(("out", "xs", "x2s"), got, ref):
        assert a.dtype == tdt, name
        _close(a, _f32(r)[:, :s] if name == "out" else _f32(r)[:, :, :s], dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
def test_fused_block_matches_pallas_at_head_dim_80(s, dtype):
    """`fused_block`'s output, dx and 12 weight gradients for the loss
    sum(out * cot) against the JAX `fused_block` (`_fwd_kernel` forward,
    split `_layer_bwd` backward, interpret mode)."""
    d, heads, mlp = NARROW
    jdt, tdt = DTYPES[dtype]
    rng, ws = _narrow_weights(s + 81)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    cot = (0.1 * rng.standard_normal((B, s, d))).astype(np.float32)
    jw, tw = _typed(ws, jdt, tdt)

    def loss(xx, ww):
        out = jfb.fused_block(xx, ww, heads, EPS, 2, True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, ref), (ref_dx, ref_dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jdt), jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = tuple(t.requires_grad_(True) for t in tw)
    out = fb.fused_block(xt, wt, heads, EPS, fast_gelu=False)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    _close(out, ref, dtype, "out")
    _close(xt.grad, ref_dx, dtype, "dx", True)
    for n, w, r in zip(fb.WEIGHT_NAMES, wt, ref_dw):
        _close(w.grad, r, dtype, n, True)


@pytest.mark.parametrize("merged", [False, True], ids=["split", "merged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
def test_layer_bwd_matches_pallas_at_head_dim_80(s, dtype, merged):
    """`mlp_bwd` then `attn_bwd`, or `merged_bwd` (on the CPU their twins),
    against `_layer_bwd` (split or merged) in interpret mode: dx and the 12
    weight gradients."""
    d, heads, mlp = NARROW
    jdt, tdt = DTYPES[dtype]
    rng, ws = _narrow_weights(s + 82)
    x, x2 = (rng.standard_normal((B, s, d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((B, s, d))).astype(np.float32)
    ref_dx, ref_g = _layer_bwd_ref(x, x2, g, ws, heads, s, jdt, merged)
    tw = dict(zip(fb.WEIGHT_NAMES, _typed(ws, jdt, tdt)[1]))
    tx, tx2, tg = (torch.from_numpy(a).to(tdt) for a in (x, x2, g))
    if merged:
        dx, grads = fb.merged_bwd(tx, tx2, tg, tw, heads, EPS, False)
    else:
        dx2, grads = fb.mlp_bwd(tx2, tg, tw, EPS, False)
        dx, agrads = fb.attn_bwd(tx, dx2, tw, heads, EPS)
        grads = {**grads, **agrads}
    assert dx.dtype == tdt
    _close(dx, _f32(ref_dx)[:, :s], dtype, "dx", True)
    for n in fb.WEIGHT_NAMES:
        assert grads[n].dtype == torch.float32, n
        _close(grads[n], _f32(ref_g[n]).reshape(ws[n].shape), dtype, n, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
def test_mha_pallas_matches_jax_at_head_dim_80(s, dtype):
    """The port's `mha_pallas` forward and gradients against the JAX one,
    its flash kernels in interpret mode, at head_dim 80 (two heads)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, cot = _attention_operands((B, s, 2, 80), s + 83)
    ref, ref_g = _jax_mha(q, k, v, cot, jdt)
    got, got_g = _port_mha(q, k, v, cot, tdt)
    assert got.dtype == tdt and all(g.dtype == tdt for g in got_g)
    _close_mha(got, got_g, ref, ref_g, dtype)


# ---------------------------------------------------------------------------
# 4. the streamed kernels' order of sums at head_dim 80, at every S
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["stage", "core", "flash", "fp32_multipass"])
@pytest.mark.parametrize("s", SEQS)
def test_streamed_order_matches_pallas_at_head_dim_80(s, route, monkeypatch):
    """Each twin replaced by tests/test_torch_general_long.py's emulation of
    the kernel's order of sums (5 k-steps of 16 for the scores at head_dim
    80), against interpret-mode Pallas: the backbone (gl_fwd_kernel<80,
    false>), the split layer backward (gl_core_kernel<80>), mha_pallas in
    bf16 (gl_fwd_kernel<80, true>, gl_flash_rows / _cols_kernel<80>, all on
    wgmma with the mma.sync kernels' orders) and in fp32 (the multi-pass
    route on one image and head)."""
    d, heads, mlp = NARROW
    if route == "stage":
        rng, ws = _narrow_weights(s + 84, layers=L)
        x = rng.standard_normal((B, s, d)).astype(np.float32)
        jw, tw = _typed(ws, jnp.bfloat16, torch.bfloat16)
        ref = jfb.fused_backbone(jnp.asarray(x, jnp.bfloat16), jw, heads, EPS, 2, True)
        monkeypatch.setattr(fb, "mha_plain", _gl_stage)
        got = fb.fused_backbone(torch.from_numpy(x).to(torch.bfloat16), tw, heads, EPS,
                                fast_gelu=False)
        _close(got, ref, "bfloat16", "out")
    elif route == "core":
        rng, w = _narrow_weights(s + 85)
        x, x2 = (rng.standard_normal((B, s, d)).astype(np.float32) for _ in range(2))
        g = (0.1 * rng.standard_normal((B, s, d))).astype(np.float32)
        ref_dx, ref_g = _layer_bwd_ref(x, x2, g, w, heads, s, jnp.bfloat16, False)
        tw = {k: torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else torch.bfloat16)
              for k, v in w.items()}
        tx, tx2, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, x2, g))
        monkeypatch.setattr(fb, "_attention_bwd", _gl_core)
        dx2, grads = fb.mlp_bwd_plain(tx2, tg, tw, EPS, False)
        dx, agrads = fb.attn_bwd_plain(tx, dx2, tw, heads, EPS)
        grads.update(agrads)
        _close(dx, _f32(ref_dx)[:, :s], "bfloat16", "dx", True)
        for n in fb.WEIGHT_NAMES:
            _close(grads[n], np.asarray(ref_g[n]).reshape(w[n].shape), "bfloat16", n, True)
    elif route == "flash":
        q, k, v, cot = _attention_operands((B, s, 2, 80), s + 86)
        ref, ref_g = _jax_mha(q, k, v, cot, jnp.bfloat16)
        monkeypatch.setattr(fa, "flash_attention_plain", _gl_flash_fwd)
        monkeypatch.setattr(fa, "flash_attention_bwd_plain", _gl_flash_bwd)
        got, got_g = _port_mha(q, k, v, cot, torch.bfloat16)
        _close_mha(got, got_g, ref, ref_g, "bfloat16")
    else:
        q, k, v, cot = _attention_operands((1, s, 1, 80), s + 87)
        ref, ref_g = _jax_mha(q, k, v, cot, jnp.float32)

        def fwd(q_, k_, v_):
            return _tokens(_multipass_f32(*(_heads(t) for t in (q_, k_, v_)), _heads(v_))[0],
                           q_.dtype)

        def bwd(q_, k_, v_, do_):
            out = _multipass_f32(*(_heads(t) for t in (q_, k_, v_, do_)))
            return tuple(_tokens(t, q_.dtype) for t in out[1:])

        monkeypatch.setattr(fa, "flash_attention_plain", fwd)
        monkeypatch.setattr(fa, "flash_attention_bwd_plain", bwd)
        got, got_g = _port_mha(q, k, v, cot, torch.float32)
        _close_mha(got, got_g, ref, ref_g, "float32")


# ---------------------------------------------------------------------------
# 5. one layer at ViT-Huge's width
# ---------------------------------------------------------------------------

def _wide_weights(rng):
    """One block at D 1280, std scaled by 1 / sqrt(D / 64) (as
    tests/test_torch_vit_large.py), W1 large enough that the gelu forms
    differ."""
    k = (64 / D) ** 0.5

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "ln1_scale": 1.0 + n(D, std=0.1), "ln1_bias": n(D, std=0.1),
        "wqkv": n(D, 3 * D, std=0.1 * k), "bqkv": n(3 * D, std=0.05),
        "wo": n(D, D, std=0.1 * k), "bo": n(D, std=0.05),
        "ln2_scale": 1.0 + n(D, std=0.1), "ln2_bias": n(D, std=0.1),
        "w1": n(D, MLP, std=0.4 * k), "b1": n(MLP, std=0.05),
        "w2": n(MLP, D, std=0.1 * k), "b2": n(D, std=0.05),
    }


def _close_wide(got, ref, dtype, what):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    atol, mean_tol = WIDE_TOL[dtype]
    if mean_tol is None:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-4, err_msg=what)
        return
    mx = float(np.abs(ref).max()) or 1.0
    err = np.abs(got - ref)
    assert err.max() <= atol * mx, (what, float(err.max()), mx)
    assert err.mean() <= mean_tol * mx, (what, float(err.mean()), mx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_matches_jax_at_vit_huge_width(dtype):
    """One ViT-Huge/14 layer (D 1280, 16 heads of 80, mlp 5120) at B = 1, S
    = 17: the port's `fused_block` output, dx and weight gradients against
    the JAX `fused_block` (its Pallas forward and backward in interpret
    mode)."""
    rng = np.random.default_rng(1280)
    ws = _wide_weights(rng)
    x = rng.standard_normal((1, 17, D)).astype(np.float32)
    cot = (0.1 * rng.standard_normal((1, 17, D))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jw, tw = _typed(ws, jdt, tdt)

    def loss(xx, ww):
        out = jfb.fused_block(xx, ww, HEADS, EPS, 1, True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, ref), (ref_dx, ref_dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jdt), jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = tuple(t.requires_grad_(True) for t in tw)
    out = fb.fused_block(xt, wt, HEADS, EPS, fast_gelu=False)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tdt and out.shape == (1, 17, D)
    _close_wide(out, ref, dtype, "out")
    _close_wide(xt.grad, ref_dx, dtype, "dx")
    for n, w, r in zip(fb.WEIGHT_NAMES, wt, ref_dw):
        _close_wide(w.grad, r, dtype, n)


# ---------------------------------------------------------------------------
# 6. the weights carried across at head_dim 80
# ---------------------------------------------------------------------------

NARROW_VIT = dict(image_size=224, patch_size=14, hidden_size=160, num_layers=2, num_heads=2,
                  mlp_dim=320)


def test_convert_and_npz_carry_head_dim_80_weights(tmp_path):
    """A JAX-initialised backbone at head_dim 80 (D 160, patch 14, 224 px:
    S = 257), with nonzero biases: `from_jax` gives the port the same
    features (fp32, atol 2e-5: the JAX XLA block's exact erf gelu against
    the A&S erf of the port's kernels, as tests/test_torch_vit.py); the JAX
    `.npz` checkpoint restores strictly into the port's init bit for bit,
    and the port's `.npz` restores strictly into JAX bit for bit."""
    jc, tc = JViTConfig(**NARROW_VIT), ViTConfig(**NARROW_VIT)
    assert tc.seq_len == 257 and tc.head_dim == 80
    p = jax.device_get(jvit.init_vit(jax.random.key(80), jc))
    rng = np.random.default_rng(80)
    for name in ("bqkv", "bo", "b1", "b2", "ln1_bias", "ln2_bias"):
        p["blocks"][name] = (0.05 * rng.standard_normal(p["blocks"][name].shape)
                             ).astype(np.float32)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jvit.vit_features(p, jnp.asarray(x), jc, JFP32, None))
    tp = from_jax(p, device="cpu")
    got = tvit.vit_features(tp, torch.from_numpy(x), tc, FP32, fast_gelu=False)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)

    jax_path = str(tmp_path / "jax.npz")
    jckpt.save(jax_path, p, {"geometry": "head_dim 80"})
    like = tvit.init_vit(torch.Generator().manual_seed(0), tc, device="cpu")
    restored = ckpt.restore(jax_path, like, strict=True)
    flat_t, flat_p = ckpt._flatten(restored), ckpt._flatten(tp)
    assert sorted(flat_t) == sorted(flat_p)
    for key in flat_p:
        assert torch.equal(torch.as_tensor(flat_t[key]), torch.as_tensor(flat_p[key])), key
    again = tvit.vit_features(restored, torch.from_numpy(x), tc, FP32, fast_gelu=False)
    assert torch.equal(again, got)

    port_path = str(tmp_path / "port.npz")
    ckpt.save(port_path, tp, {"geometry": "head_dim 80"})
    back = jckpt.restore(port_path, p, strict=True)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(p)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jckpt._path_key(path))
