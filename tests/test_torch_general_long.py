"""The general route above 256 tokens: head_dim 16, 32 and 48 (D 32, 64 and
96 at 2 heads), and head_dim 64 with mlp 96, at S = 257 (the folder
datasets at 256 px) and 290 (272 px), through the port on the CPU against
the JAX package's Pallas kernels in interpret mode, which pad the sequence
and take the softmax over the whole padded row.

On the CPU every wrapper runs its plain twin, which takes any geometry; on
the card these geometries take the general route's multi-pass attention
kernels above 256 keys (csrc/general_long.cuh in bf16 at head_dim 16-48,
csrc/long_attention.cuh at head_dim 64, csrc/flash_f32.cuh's multi-pass
route in fp32), held against the same twins by chip_smoke.py (phase 19).
Here, at tiny widths (2 layers, B = 2):

1. the twins against interpret-mode Pallas at every geometry, both S and
   both dtypes: the backbone forward with its xs / x2s stacks, one layer
   (`fused_block`: forward, dx and the weight gradients), the split and the
   merged layer backward, and `mha_pallas` with its gradients;
2. a plain-torch emulation of each new kernel's order of sums, in the same
   place of the same computation, against interpret-mode Pallas (bf16):
   the scores as fp32 sums of 16-wide k-steps of head_dim scaled by the
   fp32 1/sqrt(dh), each row's max over every key, the row sum as a lane
   sums its keys (8 j + 2 t, 8 j + 2 t + 1, in ascending order across the
   64-key chunks) and the quad adds its four lanes, the IEEE quotient, the
   products with P and dS as fp32 sums over 16-key (16-query) k-steps in
   order, P and dS one bf16 term (the fused block's stage and core) or two
   (the flash pair: hi = bf16(x), lo = bf16(x - hi)); every one of these
   kernels (the stage, the flash forward, the core and the flash
   backward's two launches) runs on wgmma, whose accumulator holds each
   lane's mma.sync fragment positions, and keeps the orders of the
   mma.sync kernels it replaced; and the fp32 multi-pass route's order
   (per 256-key chunk, csrc/flash_f32.cuh) at the three head_dims;
3. two SSP optimizer steps of the tiny model (D 32, 2 heads, mlp 64: head
   dim 16) at image_size 272 (S = 290) against the JAX trainer, the
   weights carried over by models/convert.py.

Inputs come from numpy with a seed and go to both sides. Tolerances are
tests/test_torch_long_seq.py's (the head_dim-64 routes above 256 tokens):
fp32 differs by float32 reassociation only, bf16 rounds at the same points
on both sides and sums in other orders, so a value near a rounding boundary
lands one bf16 step away."""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.core.config import SSPConfig as JSSPConfig
from vit2spn_tpu.core.config import ViTConfig as JViTConfig
from vit2spn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.ops import flash_attention as fa
from vit2spn_tpu_torch.ops import fused_block as fb
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

# the helpers tests/test_torch_long_seq.py holds the head_dim-64 long routes
# with (weights, comparisons at its tolerances, the mha_pallas pair, the
# emulations' sums that do not depend on the head_dim)
from test_torch_long_seq import (
    _attention_operands,
    _bf,
    _chunk_lane_sum,
    _close,
    _close_mha,
    _dots,
    _f32,
    _fma,
    _heads,
    _jax_mha,
    _ksum,
    _lane_sum,
    _pad,
    _port_cfg,
    _port_mha,
    _split_mm,
    _tokens,
    _typed,
    _weights,
)

# the module, not the `fused_block` function vit2spn_tpu.ops exports
jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

L, B = 2, 2
EPS = 1e-12
SEQS = [257, 290]
# (D, heads, mlp): head_dim 16, 32, 48 at 2 heads, and head_dim 64 with an
# mlp that is a multiple of 32 only (the general route around the head_dim-64
# attention routes)
GEOMS = {"dh16": (32, 2, 64), "dh32": (64, 2, 128), "dh48": (96, 2, 192),
         "dh64_mlp96": (64, 1, 96)}
HEAD_DIMS = (16, 32, 48)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_CHUNK = 256  # csrc/flash_f32.cuh LF_CHUNK: the multi-pass route's chunks


def _layer_bwd_ref(x, x2, g, ws, heads, s, jdt, merged):
    """`_layer_bwd` (split, or merged) in interpret mode on seq-padded
    inputs in the compute dtype."""
    sp = (s + 15) // 16 * 16
    jw = {n: jnp.asarray(ws[n], jnp.float32 if n.startswith("ln") else jdt)
          for n in fb.WEIGHT_NAMES}
    return jfb._layer_bwd(*(_pad(a, sp).astype(jdt) for a in (x, x2, g)), jw, heads, s, sp,
                          EPS, 2, True, merged=merged)


# ---------------------------------------------------------------------------
# 1. the twins against interpret-mode Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("geom", GEOMS)
def test_backbone_with_its_stacks_matches_pallas_above_256(geom, s, dtype):
    """`fused_backbone` (two layers) with `emit_res` (out, xs, x2s) against
    `_backbone_fwd_impl(emit_res=True)` in interpret mode, whose outputs are
    seq-padded to 16: the first S rows are compared."""
    d, heads, mlp = GEOMS[geom]
    jdt, tdt = DTYPES[dtype]
    rng, ws = _weights(s + d + mlp, d, mlp, layers=L)
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
@pytest.mark.parametrize("geom", GEOMS)
def test_fused_block_matches_pallas_above_256(geom, s, dtype):
    """`fused_block`'s output, dx and 12 weight gradients for the loss
    sum(out * cot) against the JAX `fused_block`: `_fwd_kernel` forward, the
    split `_layer_bwd` backward, both in interpret mode."""
    d, heads, mlp = GEOMS[geom]
    jdt, tdt = DTYPES[dtype]
    rng, ws = _weights(s + d + mlp + 1, d, mlp)
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
@pytest.mark.parametrize("geom", GEOMS)
def test_layer_bwd_matches_pallas_above_256(geom, s, dtype, merged):
    """The layer backward through the wrappers (on the CPU their twins):
    `mlp_bwd` then `attn_bwd`, or `merged_bwd`, against `_layer_bwd` (split,
    or merged: `_merged_bwd_kernel`) in interpret mode on seq-padded
    tensors: dx and the 12 weight gradients."""
    d, heads, mlp = GEOMS[geom]
    jdt, tdt = DTYPES[dtype]
    rng, ws = _weights(s + d + mlp + 2, d, mlp)
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
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_mha_pallas_matches_jax_above_256(dh, s, dtype):
    """The port's `mha_pallas` forward and gradients against the JAX one,
    whose flash kernels run in interpret mode on the sequence padded to 384,
    at head_dim 16, 32 and 48 (two heads)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, cot = _attention_operands((B, s, 2, dh), s + dh)
    ref, ref_g = _jax_mha(q, k, v, cot, jdt)
    got, got_g = _port_mha(q, k, v, cot, tdt)
    assert got.dtype == tdt and all(g.dtype == tdt for g in got_g)
    _close_mha(got, got_g, ref, ref_g, dtype)


# ---------------------------------------------------------------------------
# 2. the new kernels' order of sums
# ---------------------------------------------------------------------------

def _scale(dh):
    """1 / sqrt(dh) rounded once to fp32 (common.cuh attention_scale)."""
    return torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)


def _scores(q, k):
    """fp32 scores of (B, H, S, dh) q, k: 16-wide k-steps of head_dim in
    order (DH / 16 of them), times the fp32 scale."""
    dh = q.shape[-1]
    return _ksum(q, k.transpose(-1, -2), dh) * _scale(dh)


def _probs(q, k):
    """fp32 P: the row max over every key, exp(s - max), the lane-ordered
    row sum, the IEEE quotient."""
    sc = _scores(q, k)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    return p / _lane_sum(p)[..., None]


def _gl_stage(q, k, v):
    """gl_fwd_kernel<DH, false>, the fused layer's stage: bf16(bf16(P) v),
    P V over 16-key k-steps in order."""
    qf, kf, vf = (_heads(t) for t in (q, k, v))
    o = _ksum(_bf(_probs(qf, kf)), vf, qf.shape[-2])
    return _tokens(o, q.dtype)


def _gl_core(qkv, datt, heads):
    """gl_core_kernel<DH> in `fb._attention_bwd`'s interface: att as the
    stage computes it; rowsum(dP P) lane-ordered; dS = bf16(P (dP -
    rowsum)); dQ over 16-key k-steps; dK and dV over 16-query k-steps (the
    cols phase)."""
    dtype = qkv.dtype
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (_heads(t.reshape(b, s, heads, dh)) for t in qkv.split(d, dim=-1))
    do = _heads(datt.reshape(b, s, heads, dh))
    p = _probs(q, k)
    att = _ksum(_bf(p), v, s)
    dp = _ksum(do, v.transpose(-1, -2), dh)
    ds = _bf(p * (dp - _lane_sum(dp * p)[..., None]))
    dq = _ksum(ds, k, s) * _scale(dh)
    dk = _ksum(ds.transpose(-1, -2), q, s) * _scale(dh)
    dv = _ksum(_bf(p).transpose(-1, -2), do, s)

    def merge(t):
        return t.permute(0, 2, 1, 3).reshape(b, s, d)

    return merge(att).to(dtype), torch.cat([merge(dq), merge(dk), merge(dv)], -1).to(dtype)


def _gl_flash_fwd(q, k, v):
    """gl_fwd_kernel<DH, true>: P in two bf16 terms."""
    qf, kf, vf = (_heads(t) for t in (q, k, v))
    return _tokens(_split_mm(_probs(qf, kf), vf, qf.shape[-2]), q.dtype)


def _gl_flash_bwd(q, k, v, do):
    """gl_flash_rows_kernel (rowsum(dP P) lane-ordered, dQ over 16-key
    k-steps with dS in two terms, hi before lo) then gl_flash_cols_kernel
    (dK and dV over 16-query k-steps, P and dS in two terms), both on wgmma
    with the orders of the mma.sync kernels they replaced."""
    qf, kf, vf, dof = (_heads(t) for t in (q, k, v, do))
    s, dh = qf.shape[-2], qf.shape[-1]
    p = _probs(qf, kf)
    dp = _ksum(dof, vf.transpose(-1, -2), dh)
    ds = p * (dp - _lane_sum(dp * p)[..., None])
    dq = _split_mm(ds, kf, s) * _scale(dh)
    dk = _split_mm(ds.transpose(-1, -2), qf, s) * _scale(dh)
    dv = _split_mm(p.transpose(-1, -2), dof, s)
    return tuple(_tokens(t, q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_general_stage_order_matches_pallas_bf16(dh, s, monkeypatch):
    """The backbone twin with its attention replaced by the new stage's
    order of sums, against `_backbone_fwd_kernel` in interpret mode (bf16);
    and the emulation is mha_plain's function to within a bf16 step."""
    d, heads, mlp = 2 * dh, 2, 4 * dh
    rng, ws = _weights(s + dh + 3, d, mlp, layers=L)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    jw, tw = _typed(ws, jnp.bfloat16, torch.bfloat16)
    ref = jfb.fused_backbone(jnp.asarray(x, jnp.bfloat16), jw, heads, EPS, 2, True)
    monkeypatch.setattr(fb, "mha_plain", _gl_stage)
    got = fb.fused_backbone(torch.from_numpy(x).to(torch.bfloat16), tw, heads, EPS,
                            fast_gelu=False)
    _close(got, ref, "bfloat16", "out")
    monkeypatch.undo()
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in rng.standard_normal((3, B, s, heads, dh)).astype(np.float32))
    np.testing.assert_allclose(_f32(_gl_stage(q, k, v)), _f32(fb.mha_plain(q, k, v)),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_general_core_order_matches_pallas_bf16(dh, s, monkeypatch):
    """The split layer backward with its attention core replaced by the new
    core's order of sums (bf16), against `_layer_bwd` in interpret mode: dx
    and every weight gradient."""
    d, heads, mlp = 2 * dh, 2, 4 * dh
    rng, w = _weights(s + dh + 4, d, mlp)
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


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_general_flash_order_matches_pallas_bf16(dh, s, monkeypatch):
    """mha_pallas with its twins replaced by the flash kernels' order of
    sums (P and dS in two bf16 terms; the wgmma flash forward and flash
    backward keep it), against the JAX mha_pallas in interpret mode, at the
    bf16 bounds of section 1."""
    q, k, v, cot = _attention_operands((B, s, 2, dh), s + dh + 5)
    ref, ref_g = _jax_mha(q, k, v, cot, jnp.bfloat16)
    monkeypatch.setattr(fa, "flash_attention_plain", _gl_flash_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _gl_flash_bwd)
    got, got_g = _port_mha(q, k, v, cot, torch.bfloat16)
    _close_mha(got, got_g, ref, ref_g, "bfloat16")


# The fp32 multi-pass route (csrc/flash_f32.cuh above 256 keys, on the head
# dim): each score over head_dim in ascending order (one fma a term), l and
# rowsum(dP p) per 256-key chunk as a lane sums its keys 32 j + lane (j
# ascending) and the warp's butterfly adds its lanes, the chunks in order;
# the products with p and dS over keys (queries) in ascending order within
# each chunk, the chunks' partial sums added in order. fp32 fma is emulated
# in float64 (exact product, then one rounding to fp32).

def _chunk_product(w, r, s):
    """sum over k < s of w[..., i, k] r[..., k, :] (`product`): per 256-key
    chunk one fma a term in ascending order from 0, the chunks' partial sums
    added in order."""
    out = None
    for c0 in range(0, s, F32_CHUNK):
        part = torch.zeros(*w.shape[:-1], r.shape[-1])
        for k in range(c0, min(c0 + F32_CHUNK, s)):
            part = _fma(w[..., k:k + 1], r[..., k:k + 1, :], part)
        out = part if out is None else out + part
    return out


def _multipass_f32(q, k, v, do):
    """flash_f32.cuh's multi-pass route on (B, H, S, dh) fp32: m over every
    key, l per chunk, p = exp(s - m) / l; o = p v; the rows phase's
    rowsum(dP p) and dS, dQ; the cols phase's dV and dK. Returns o, dq, dk,
    dv."""
    s, dh = q.shape[-2], q.shape[-1]
    sc = _dots(q, k) * _scale(dh)
    m = sc.amax(-1, keepdim=True)
    e = torch.exp(sc - m)
    p = e / _chunk_lane_sum(e)[..., None]
    o = _chunk_product(p, v, s)
    dp = _dots(do, v)
    ds = p * (dp - _chunk_lane_sum(dp, p)[..., None])
    dq = _chunk_product(ds, k, s) * _scale(dh)
    dk = _chunk_product(ds.transpose(-1, -2), q, s) * _scale(dh)
    dv = _chunk_product(p.transpose(-1, -2), do, s)
    return o, dq, dk, dv


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_fp32_multipass_order_matches_pallas(dh, s, monkeypatch):
    """mha_pallas in fp32 with its twins replaced by the emulation of the
    multi-pass route's order of sums at head_dim 16, 32, 48 (one image, one
    head), against the JAX mha_pallas in interpret mode (fp32 bounds of
    section 1)."""
    q, k, v, cot = _attention_operands((1, s, 1, dh), s + dh + 7)
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
# 3. two SSP steps of the tiny model at 272 px (S = 290)
# ---------------------------------------------------------------------------

def test_tiny_model_ssp_trajectory_at_272px_matches_jax(tiny_ssp):
    """Two optimizer steps (2 microbatches of 4, Adam, EMA) of the port's
    "fused" path at the tiny model's width (D = 32, 2 heads of 16, mlp 64)
    and image_size 272 (17 x 17 patches + cls = 290 tokens) against the JAX
    trainer from the same weights on the same batches, augmentation and
    dropout off: losses within 3e-5, parameters within 2e-5
    (tests/test_torch_train.py's bounds)."""
    vit = JViTConfig(image_size=272, patch_size=16, hidden_size=32, num_layers=2,
                     num_heads=2, mlp_dim=64)
    assert (vit.seq_len, vit.head_dim) == (290, 16)
    data = dataclasses.replace(tiny_ssp.data, augment=dataclasses.replace(
        tiny_ssp.data.augment, out_size=272, enabled=False))
    jcfg = dataclasses.replace(tiny_ssp, vit=vit, data=data, batch_size=4,
                               accumulation_steps=2, proj_dropout=0.0)
    assert isinstance(jcfg, JSSPConfig)
    jt = JaxSSPTrainer(jcfg, logger=JaxLogger(echo=False))
    pt = SSPTrainer(_port_cfg(jcfg), logger=MetricLogger(echo=False), device="cpu")
    pt.state = pt.state._replace(params=from_jax(jax.device_get(jt.state.params),
                                                 device="cpu"))
    assert pt.attn_impl == "fused"
    assert fb.geometry_route(32, 2, 64, 290) == (fb.ROUTE_GENERAL, "")
    ds = jax_synthetic(image_size=28, split_sizes={"train": 16}, seed=11)
    eff = jcfg.effective_batch
    for step in range(2):
        batch = ds.images[step * eff:(step + 1) * eff]
        ref = float(jt.train_step(batch, jax.random.key(step))["loss"])
        got = float(pt.train_step(batch, (0, step))["loss"])
        assert math.isfinite(got)
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0, err_msg=f"step {step}")
    ref = jax.tree_util.tree_flatten_with_path(jax.device_get(jt.state.params))[0]
    got = ckpt._flatten(pt.state.params)
    assert got["online/pos_embed"].shape[-3:] == (1, 290, 32)
    for path, leaf in ref:
        key = jckpt._path_key(path)
        np.testing.assert_allclose(got[key], np.asarray(leaf), atol=2e-5, rtol=0, err_msg=key)
