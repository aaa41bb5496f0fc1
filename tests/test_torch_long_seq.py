"""Sequences above 256 tokens (384 px images: S = 577; the folder datasets at
256 px: S = 257) through the port on the CPU, against the JAX package's
Pallas kernels in interpret mode, which pad the sequence and take the
softmax over the whole padded row.

On the CPU every wrapper runs its plain twin, which takes any S; on the card
the four bf16 attention kernels take csrc/long_attention.cuh's multi-pass
routes above 256 keys, held against the twins by chip_smoke.py (phase 15).
Here, at tiny widths (D 64-128, head_dim 64, 2 layers, B <= 4):

1. the twins against interpret-mode Pallas at S = 257 and 290 (300 for the
   flash pair, which pads to 384): the backbone and one-layer forwards, the
   split and merged layer backwards, and mha_pallas with its gradients;
2. a plain-torch emulation of each long route's order of sums, held in the
   same place of the same computation against interpret-mode Pallas: the
   scores as fp32 sums of 16-wide k-steps of head_dim, each row's max over
   every key, the row sum as a lane sums its keys (keys 2t, 2t + 1 mod 8 in
   ascending order, over 64-key chunks) and the quad adds its four lanes,
   the IEEE quotient, the products with P and dS as fp32 sums over 16-key
   (or 16-query) k-steps in order, P and dS one bf16 term (the fused block)
   or two (flash: hi = bf16(x), lo = bf16(x - hi)); and the fp32 routes'
   (csrc/flash_f32.cuh) order of sums, the one-pass route's emulation
   against interpret-mode Pallas and against the multi-pass route's (the
   same p bit for bit; section 2b);
3. two SSP optimizer steps at image_size 272 (S = 290) against the JAX
   trainer, the weights carried over by models/convert.py.

Inputs come from numpy with a seed and go to both sides. Tolerances as the
files for S <= 256 state them: fp32 differs by float32 reassociation only,
bf16 rounds at the same points on both sides and sums in other orders, so a
value near a rounding boundary lands one bf16 step away."""

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
from vit2spn_tpu.ops.flash_attention import mha_pallas as jax_mha_pallas
from vit2spn_tpu.train import checkpoint as jckpt
from vit2spn_tpu.train.ssp import SSPTrainer as JaxSSPTrainer
from vit2spn_tpu.utils.logging import MetricLogger as JaxLogger
from vit2spn_tpu_torch.core import config as tcfg
from vit2spn_tpu_torch.models.convert import from_jax
from vit2spn_tpu_torch.ops import flash_attention as fa
from vit2spn_tpu_torch.ops import fused_block as fb
from vit2spn_tpu_torch.train import checkpoint as ckpt
from vit2spn_tpu_torch.train.ssp import SSPTrainer
from vit2spn_tpu_torch.utils.logging import MetricLogger

# the module, not the `fused_block` function vit2spn_tpu.ops exports
jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

L, B = 2, 2
EPS = 1e-12
SEQS = [257, 290]
WIDTHS = {257: (64, 1, 128), 290: (128, 2, 256)}  # S: (D, heads, mlp), head_dim 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: float32 reassociation over sums of up to 290 terms (forward atol,
# gradient atol); bf16: the largest and the mean error relative to the
# output's largest magnitude (tests/test_torch_backward.py's bounds)
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (4e-2, 5e-3)}
CHUNK = 64  # csrc/long_attention.cuh LA_CHUNK: keys per staged chunk


def _weights(seed, d, mlp, layers=None):
    """Block weights (stacked with `layers`) with nonzero biases and LN
    params; W1 large enough that the gelu forms differ."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)

    def n(*shape, std):
        return (rng.standard_normal(lead + shape) * std).astype(np.float32)

    ws = {
        "ln1_scale": 1.0 + n(d, std=0.1), "ln1_bias": n(d, std=0.1),
        "wqkv": n(d, 3 * d, std=0.1), "bqkv": n(3 * d, std=0.05),
        "wo": n(d, d, std=0.1), "bo": n(d, std=0.05),
        "ln2_scale": 1.0 + n(d, std=0.1), "ln2_bias": n(d, std=0.1),
        "w1": n(d, mlp, std=0.4), "b1": n(mlp, std=0.05),
        "w2": n(mlp, d, std=0.1), "b2": n(d, std=0.05),
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


def _close(got, ref, dtype, what, grad=False):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL[dtype][grad], rtol=1e-4, err_msg=what)
    else:
        mx = float(np.abs(ref).max()) or 1.0
        err = np.abs(got - ref)
        assert err.max() <= TOL[dtype][0] * mx, (what, float(err.max()), mx)
        assert err.mean() <= TOL[dtype][1] * mx, (what, float(err.mean()), mx)


def _pad(x, sp):
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, sp - x.shape[1]), (0, 0)))


# ---------------------------------------------------------------------------
# 1. the twins against interpret-mode Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
def test_backbone_twin_matches_pallas_above_256(s, dtype):
    """`fused_backbone` (two layers) against `_backbone_fwd_kernel`."""
    d, heads, mlp = WIDTHS[s]
    jdt, tdt = DTYPES[dtype]
    rng, ws = _weights(s, d, mlp, layers=L)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    jw, tw = _typed(ws, jdt, tdt)
    ref = jfb.fused_backbone(jnp.asarray(x, jdt), jw, heads, EPS, 2, True)
    got = fb.fused_backbone(torch.from_numpy(x).to(tdt), tw, heads, EPS, fast_gelu=False)
    assert got.shape == (B, s, d) and got.dtype == tdt
    _close(got, ref, dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQS)
def test_fused_block_matches_pallas_above_256(s, dtype):
    """`fused_block`'s output, dx and 12 weight gradients for the loss
    sum(out * cot) against the JAX `fused_block`: `_fwd_kernel` forward, the
    split `_layer_bwd` backward, both in interpret mode."""
    d, heads, mlp = WIDTHS[s]
    jdt, tdt = DTYPES[dtype]
    rng, ws = _weights(s + 1, d, mlp)
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
def test_layer_bwd_twins_match_pallas_above_256(merged):
    """fp32 `mlp_bwd_plain` then `attn_bwd_plain` (or `merged_bwd_plain`)
    against `_layer_bwd` in interpret mode at S = 290 (padded to 304)."""
    s, sp = 290, 304
    d, heads, mlp = WIDTHS[s]
    rng, w = _weights(3, d, mlp)
    x, x2 = (rng.standard_normal((B, s, d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((B, s, d))).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    ref_dx, ref_g = jfb._layer_bwd(_pad(x, sp), _pad(x2, sp), _pad(g, sp), jw, heads, s, sp,
                                   EPS, 2, True, merged=merged)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    tx, tx2, tg = (torch.from_numpy(a) for a in (x, x2, g))
    if merged:
        dx, grads = fb.merged_bwd_plain(tx, tx2, tg, tw, heads, EPS, False)
    else:
        dx2, grads = fb.mlp_bwd_plain(tx2, tg, tw, EPS, False)
        dx, agrads = fb.attn_bwd_plain(tx, dx2, tw, heads, EPS)
        grads = {**grads, **agrads}
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx)[:, :s], atol=2e-4, rtol=0)
    for n in fb.WEIGHT_NAMES:
        np.testing.assert_allclose(grads[n].numpy(), np.asarray(ref_g[n]).reshape(w[n].shape),
                                   atol=2e-4, rtol=0, err_msg=n)


def _attention_operands(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    cot = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, cot


def _jax_mha(q, k, v, cot, jdt):
    args = tuple(jnp.asarray(t, jdt) for t in (q, k, v))

    def loss(*a):
        out = jax_mha_pallas(*a, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return out, grads


def _port_mha(q, k, v, cot, tdt):
    args = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in (q, k, v)]
    out = fa.mha_pallas(*args)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, [t.grad for t in args]


def _close_mha(got, got_g, ref, ref_g, dtype):
    """tests/test_torch_flash_attention.py's bounds: fp32 2e-5 forward, 5e-5
    gradients; bf16 (only the outputs rounded) 1% of the largest magnitude,
    the mean 0.1%."""
    for name, a, b, tol in [("out", got, ref, 2e-5)] + [
            (f"d{n}", a, b, 5e-5) for n, a, b in zip("qkv", got_g, ref_g)]:
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)
        else:
            scale = float(np.abs(b).max())
            err = np.abs(a - b)
            assert err.max() <= 1e-2 * scale, (name, float(err.max()), scale)
            assert err.mean() <= 1e-3 * scale, (name, float(err.mean()), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [257, 300])
def test_mha_pallas_matches_jax_above_256(s, dtype):
    """The port's `mha_pallas` forward and gradients against the JAX one,
    whose flash kernels run in interpret mode on the sequence padded to 384."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, cot = _attention_operands((2, s, 2, 64), s)
    ref, ref_g = _jax_mha(q, k, v, cot, jdt)
    got, got_g = _port_mha(q, k, v, cot, tdt)
    assert got.dtype == tdt and all(g.dtype == tdt for g in got_g)
    _close_mha(got, got_g, ref, ref_g, dtype)


def test_fp32_backbone_twin_matches_pallas_at_577():
    """fp32 at 384 px's S = 577 (csrc/flash_f32.cuh's multi-pass route on the
    card), at the smallest width (D 64, one head, mlp 128, B 1, 2 layers):
    `fused_backbone` against interpret-mode `_backbone_fwd_kernel`."""
    s, d, heads, mlp = 577, 64, 1, 128
    rng, ws = _weights(s, d, mlp, layers=L)
    x = rng.standard_normal((1, s, d)).astype(np.float32)
    jw, tw = _typed(ws, jnp.float32, torch.float32)
    ref = jfb.fused_backbone(jnp.asarray(x), jw, heads, EPS, 2, True)
    got = fb.fused_backbone(torch.from_numpy(x), tw, heads, EPS, fast_gelu=False)
    assert got.shape == (1, s, d) and got.dtype == torch.float32
    _close(got, ref, "float32", "out")


def test_fp32_mha_pallas_matches_jax_at_577():
    """fp32 `mha_pallas` forward and gradients at S = 577 (one image, one
    head) against the JAX one, whose flash kernels run in interpret mode on
    the sequence padded to 640."""
    q, k, v, cot = _attention_operands((1, 577, 1, 64), 577)
    ref, ref_g = _jax_mha(q, k, v, cot, jnp.float32)
    got, got_g = _port_mha(q, k, v, cot, torch.float32)
    assert got.dtype == torch.float32 and all(g.dtype == torch.float32 for g in got_g)
    _close_mha(got, got_g, ref, ref_g, "float32")


def test_long_seq_counters_count_fp32_routes(monkeypatch):
    """fp32 above 256 tokens passes every wrapper's input check and is
    counted by its route's counter, as bf16 is (the wrappers count on the
    card); at 256 tokens nothing is counted."""
    monkeypatch.setattr(fb, "LONG_SEQ_LAUNCHES", dict.fromkeys(fb.LONG_SEQ_LAUNCHES, 0))
    x = torch.zeros(1, 577, 64)
    fb._check_activation(x, 1)
    fb._check_activation(x, 1, core=True)
    fa._check_flash_inputs(*(x.reshape(1, 577, 1, 64),) * 3)
    routes = {"attention_fwd": 12, "attention_bwd": 1, "flash_fwd": 1, "flash_bwd": 1}
    for route, n in routes.items():
        fb.count_long_seq(route, 577, n)
        fb.count_long_seq(route, fb.KERNEL_MAX_SEQ, n)
    assert fb.LONG_SEQ_LAUNCHES == routes


# ---------------------------------------------------------------------------
# 2. the long routes' order of sums
# ---------------------------------------------------------------------------

def _bf(t):
    return t.to(torch.bfloat16).float()


def _ksum(a, b, axis_len, step=16):
    """a @ b in fp32 with the reduction taken in `step`-wide k-steps in
    order (one mma chain)."""
    out = None
    for c in range(0, axis_len, step):
        part = a[..., c:c + step] @ b[..., c:c + step, :]
        out = part if out is None else out + part
    return out


def _scores(q, k):
    """fp32 scores of (B, H, S, 64) q, k: 16-wide k-steps of head_dim in
    order, times 1/8 (exact)."""
    return _ksum(q, k.transpose(-1, -2), q.shape[-1]) * 0.125


def _lane_sum(x):
    """The sum over keys of x (..., S) as the kernels take it: lane t adds
    the keys 8j + 2t and 8j + 2t + 1 in ascending order (over the 64-key
    chunks, which keep that order), then the quad (l0 + l1) + (l2 + l3)."""
    s = x.shape[-1]
    sp = (s + CHUNK - 1) // CHUNK * CHUNK
    lanes = torch.nn.functional.pad(x, (0, sp - s)).reshape(*x.shape[:-1], sp // 8, 4, 2)
    part = torch.zeros(*x.shape[:-1], 4)
    for j in range(sp // 8):
        for e in range(2):
            part = part + lanes[..., j, :, e]
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def _probs(q, k):
    """fp32 P of the long routes: the row max over every key, exp(s - max),
    the lane-ordered row sum, the IEEE quotient."""
    sc = _scores(q, k)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    return p / _lane_sum(p)[..., None]


def _split_mm(x, rows, k_len):
    """(hi + lo) rows over 16-wide k-steps in order, hi = bf16(x), lo =
    bf16(x - hi): per step acc + hi rows, then + lo rows (flash)."""
    hi = _bf(x)
    lo = _bf(x - hi)
    out = torch.zeros(*x.shape[:-1], rows.shape[-1])
    for c in range(0, k_len, 16):
        out = out + hi[..., c:c + 16] @ rows[..., c:c + 16, :]
        out = out + lo[..., c:c + 16] @ rows[..., c:c + 16, :]
    return out


def _heads(t):  # (B, S, H, 64) -> (B, H, S, 64) fp32
    return t.float().permute(0, 2, 1, 3)


def _tokens(t, dtype):  # back to (B, S, H, 64) in dtype
    return t.permute(0, 2, 1, 3).to(dtype)


def _long_stage(q, k, v):
    """The fused layer's long attention stage (long_attention_fwd<false>):
    bf16(bf16(P) v), P V over 16-key k-steps in order."""
    qf, kf, vf = (_heads(t) for t in (q, k, v))
    o = _ksum(_bf(_probs(qf, kf)), vf, qf.shape[-2])
    return _tokens(o, q.dtype)


def _long_core(qkv, datt, heads):
    """The backward's long core (long_attention_bwd_kernel) in
    `fb._attention_bwd`'s interface: att as the stage computes it; rowsum(dP
    P) lane-ordered; dS = bf16(P (dP - rowsum)); dQ over 16-key k-steps; dK
    and dV over 16-query k-steps (the key-major pass)."""
    dtype = qkv.dtype
    b, s, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (_heads(t.reshape(b, s, heads, 64)) for t in qkv.split(d, dim=-1))
    do = _heads(datt.reshape(b, s, heads, 64))
    p = _probs(q, k)
    att = _ksum(_bf(p), v, s)
    dp = _ksum(do, v.transpose(-1, -2), 64)
    ds = _bf(p * (dp - _lane_sum(dp * p)[..., None]))
    dq = _ksum(ds, k, s) * 0.125
    dk = _ksum(ds.transpose(-1, -2), q, s) * 0.125
    dv = _ksum(_bf(p).transpose(-1, -2), do, s)

    def merge(t):
        return t.permute(0, 2, 1, 3).reshape(b, s, d)

    return merge(att).to(dtype), torch.cat([merge(dq), merge(dk), merge(dv)], -1).to(dtype)


def _long_flash_fwd(q, k, v):
    """long_attention_fwd<true>: P in two bf16 terms."""
    qf, kf, vf = (_heads(t) for t in (q, k, v))
    return _tokens(_split_mm(_probs(qf, kf), vf, qf.shape[-2]), q.dtype)


def _long_flash_bwd(q, k, v, do):
    """long_flash_bwd_rows (query-major: la_stats, then la_core_rows<false,
    true> for rowsum(dP P) and la_core_rows<true, true> for dQ) then
    long_flash_bwd_cols (key-major: la_core_cols<true> for dK and dV), both
    on wgmma: P and dS in two terms, dQ over 16-key k-steps, dK and dV over
    16-query k-steps."""
    qf, kf, vf, dof = (_heads(t) for t in (q, k, v, do))
    s = qf.shape[-2]
    p = _probs(qf, kf)
    dp = _ksum(dof, vf.transpose(-1, -2), 64)
    ds = p * (dp - _lane_sum(dp * p)[..., None])
    dq = _split_mm(ds, kf, s) * 0.125
    dk = _split_mm(ds.transpose(-1, -2), qf, s) * 0.125
    dv = _split_mm(p.transpose(-1, -2), dof, s)
    return tuple(_tokens(t, q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("s", SEQS)
def test_long_stage_order_matches_pallas_bf16(s, monkeypatch):
    """The backbone twin with its attention replaced by the long stage's
    order of sums, against `_backbone_fwd_kernel` in interpret mode (bf16);
    and the emulation is mha_plain's function to within a bf16 step."""
    d, heads, mlp = WIDTHS[s]
    rng, ws = _weights(s + 2, d, mlp, layers=L)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    jw, tw = _typed(ws, jnp.bfloat16, torch.bfloat16)
    ref = jfb.fused_backbone(jnp.asarray(x, jnp.bfloat16), jw, heads, EPS, 2, True)
    monkeypatch.setattr(fb, "mha_plain", _long_stage)
    got = fb.fused_backbone(torch.from_numpy(x).to(torch.bfloat16), tw, heads, EPS,
                            fast_gelu=False)
    _close(got, ref, "bfloat16", "out")
    monkeypatch.undo()
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in rng.standard_normal((3, B, s, heads, 64)).astype(np.float32))
    np.testing.assert_allclose(_f32(_long_stage(q, k, v)), _f32(fb.mha_plain(q, k, v)),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("s", SEQS)
def test_long_core_order_matches_pallas_bf16(s, monkeypatch):
    """The split layer backward with its attention core replaced by the
    long core's order of sums (bf16), against `_layer_bwd` in interpret
    mode: dx and every weight gradient."""
    d, heads, mlp = WIDTHS[s]
    sp = (s + 15) // 16 * 16
    rng, w = _weights(s + 3, d, mlp)
    x, x2 = (rng.standard_normal((B, s, d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((B, s, d))).astype(np.float32)
    jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jnp.bfloat16)
          for k, v in w.items()}
    ref_dx, ref_g = jfb._layer_bwd(*(_pad(a, sp).astype(jnp.bfloat16) for a in (x, x2, g)), jw,
                                   heads, s, sp, EPS, 2, True)
    tw = {k: torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else torch.bfloat16)
          for k, v in w.items()}
    tx, tx2, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, x2, g))
    monkeypatch.setattr(fb, "_attention_bwd", _long_core)
    dx2, grads = fb.mlp_bwd_plain(tx2, tg, tw, EPS, False)
    dx, agrads = fb.attn_bwd_plain(tx, dx2, tw, heads, EPS)
    grads.update(agrads)
    _close(dx, np.asarray(jnp.asarray(ref_dx).astype(jnp.float32))[:, :s], "bfloat16", "dx")
    for n in fb.WEIGHT_NAMES:
        _close(grads[n], np.asarray(ref_g[n]).reshape(w[n].shape), "bfloat16", n)


@pytest.mark.parametrize("s", [257, 300, 577])
def test_long_flash_order_matches_pallas_bf16(s, monkeypatch):
    """mha_pallas with its twins replaced by the long flash routes' order of
    sums (P and dS in two bf16 terms), against the JAX mha_pallas in
    interpret mode, at the bf16 bounds of section 1; S = 577 is
    ViT-Base/16-384's length."""
    q, k, v, cot = _attention_operands((2, s, 2, 64), s + 1)
    ref, ref_g = _jax_mha(q, k, v, cot, jnp.bfloat16)
    monkeypatch.setattr(fa, "flash_attention_plain", _long_flash_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _long_flash_bwd)
    got, got_g = _port_mha(q, k, v, cot, torch.bfloat16)
    _close_mha(got, got_g, ref, ref_g, "bfloat16")


def test_core_seq_limit_is_checked_before_a_launch():
    """bf16 S above the long core's shared-memory limit (three fp32
    statistics a query beside a tile slot and two ring stages: (232,448 -
    256 - 50,176) / 12 bytes in whole 64-query tiles) is refused
    with a ValueError naming the limit by the layer backwards' input check,
    before any launch; the forward takes any bf16 S; fp32, whose core keeps
    its statistics in device memory, takes any S."""
    limit = fb.LONG_CORE_MAX_SEQ
    assert limit == (232448 - 256 - 50176) // 12 // 64 * 64 == 15168
    fb.check_seq_len(limit, torch.bfloat16, "attention backward", core=True)
    fb.check_seq_len(4 * limit, torch.bfloat16, "backbone")
    msg = f"attention backward kernel takes S <= {limit} in bf16, got {limit + 1}"
    with pytest.raises(ValueError, match=msg):
        fb.check_seq_len(limit + 1, torch.bfloat16, "attention backward", core=True)
    fb.check_seq_len(257, torch.float32, "backbone", core=True)
    fb.check_seq_len(4 * limit, torch.float32, "attention backward", core=True)
    # the backward wrappers' check (attn_bwd, merged_bwd) takes core=True
    x = torch.zeros(1, limit + 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"S <= {limit} in bf16"):
        fb._check_layer_inputs(x, x, {}, fb.ATTN_NAMES, 1, {})
    fb._check_activation(x, 1)  # the forward's
    fb._check_activation(x.float(), 1, core=True)  # the fp32 backwards'


# ---------------------------------------------------------------------------
# 2b. the fp32 routes' order of sums (csrc/flash_f32.cuh above 256 keys)
# ---------------------------------------------------------------------------
# Both fp32 routes sum each score over head_dim in ascending order (one fma
# a term), and l and rowsum(dP p) per 256-key chunk as a lane sums its keys
# 32 j + lane (j ascending) and the warp's butterfly adds its lanes, the
# chunks in order: they form the same p and dS. The multi-pass route
# recomputes the scores per 256-key chunk and pass, and sums the products
# with p and dS over keys (queries) in ascending order within each 256-key
# (256-query) chunk, the chunks' partial sums added in order. The one-pass
# route reads the scores once from a tile and splits each staged chunk (128
# keys, 64 queries) into runs, each run's thread group summing its keys in
# ascending order over the whole row, the runs' sums added in order: 4 runs
# of 32 keys for o, 8 of 16 for dQ, 2 of 32 queries for dK and dV. fp32 fma
# is emulated in float64 (exact product, then one rounding to fp32 up to
# double rounding: the same in both emulations).

F32_CHUNK = 256  # flash_f32.cuh LF_CHUNK: the multi-pass route's chunks
F32_KC, F32_QC = 128, 64  # the one-pass route's staged chunks: keys, queries


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _dots(a, b):
    """(..., M, 64) . (..., N, 64) -> (..., M, N): dh ascending, one fma a
    term from 0 (dot_rows, op_dots)."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-2])
    for d in range(a.shape[-1]):
        acc = _fma(a[..., :, d:d + 1], b[..., None, :, d], acc)
    return acc


def _warp_sum(x):
    """The lanes (last axis, 32) added by the xor butterfly (warp_sum)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x[..., 0]


def _chunk_lane_sum(x, y=None):
    """Per 256-key chunk, lane t adds keys 32 j + t (j ascending: x, or one
    fma of x y a term), then the butterfly; the chunks added in order."""
    n = (x.shape[-1] + F32_CHUNK - 1) // F32_CHUNK * F32_CHUNK
    x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    y = None if y is None else torch.nn.functional.pad(y, (0, n - y.shape[-1]))
    total = torch.zeros(x.shape[:-1])
    for c0 in range(0, n, F32_CHUNK):
        t = torch.zeros(*x.shape[:-1], 32)
        for j in range(c0, c0 + F32_CHUNK, 32):
            t = t + x[..., j:j + 32] if y is None else _fma(x[..., j:j + 32], y[..., j:j + 32], t)
        total = total + _warp_sum(t)
    return total


def _pad_keys(t, s, n):
    return torch.nn.functional.pad(t, (0, 0, 0, n - s))


def _runs_product(w, r, s, chunk, runs, k_round=4):
    """sum over k < s of w[..., i, k] r[..., k, :]: each `chunk` of keys
    split into `runs` runs of chunk / runs keys (those below s, to the next
    k_round multiple: zeros past s), run g of every chunk summed into one
    sum in ascending order (one fma a term), the runs' sums added in order.
    One run of the whole chunk per 256 keys is the multi-pass route's order
    (its partial sums per chunk, added in order)."""
    n = (s + k_round - 1) // k_round * k_round
    w = torch.nn.functional.pad(w[..., :s], (0, n - s))
    r = _pad_keys(r[..., :s, :], s, n)
    length = chunk // runs
    parts = [torch.zeros(*w.shape[:-1], r.shape[-1]) for _ in range(runs)]
    out = None
    for c0 in range(0, s, chunk):
        for g in range(runs):
            for k in range(c0 + g * length, min(c0 + (g + 1) * length, n)):
                parts[g] = _fma(w[..., k:k + 1], r[..., k:k + 1, :], parts[g])
        if runs == 1:  # a partial sum per chunk
            out = parts[0] if out is None else out + parts[0]
            parts[0] = torch.zeros_like(parts[0])
    if runs == 1:
        return out
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _onepass_f32(q, k, v, do):
    """flash_f32.cuh's one-pass route ((B, H, S, 64) fp32): the forward's
    and the rows phase's tile of scaled scores over op_cols(S) columns
    (-1e30 past S), m over the tile's row, e = exp(s - m) in place with l,
    p = e / l; o in 4 runs; dP once, rowsum(dP p) and dS in place, dQ in 8
    runs; the cols phase's p^T from K Q^T and the statistics, dS^T, dV and
    dK in 2 runs. Returns p, o, dq, dk, dv."""
    s = q.shape[-2]
    cols = (s + F32_KC - 1) // F32_KC * F32_KC
    tile = _dots(q, _pad_keys(k, s, cols)) * 0.125
    tile[..., s:] = -1e30
    m = tile.amax(-1, keepdim=True)
    e = torch.exp(tile[..., :s] - m)
    l = _chunk_lane_sum(e)[..., None]
    p = e / l
    o = _runs_product(p, v, s, F32_KC, 4)
    dp = _dots(do, v)
    dot = _chunk_lane_sum(dp, p)[..., None]
    dq = _runs_product(p * (dp - dot), k, s, F32_KC, 8) * 0.125
    # the cols phase: keys as rows, every query as a column
    pt = torch.exp(_dots(k, q) * 0.125 - m.transpose(-1, -2)) / l.transpose(-1, -2)
    dst = pt * (_dots(v, do) - dot.transpose(-1, -2))
    dv = _runs_product(pt, do, s, F32_QC, 2)
    dk = _runs_product(dst, q, s, F32_QC, 2) * 0.125
    return p, o, dq, dk, dv


def _multipass_f32(q, k, v, do):
    """flash_f32.cuh's multi-pass route: per 256-key chunk the scores again
    in every pass (masked past S), m over the chunks, l, p, o += p v; the
    rows phase's passes for rowsum(dP p) and dS, dQ; the cols phase per
    256-query chunk; `product` walks 32-column groups. Returns p, o, dq,
    dk, dv."""
    s = q.shape[-2]
    chunks = range(0, s, F32_CHUNK)

    def scores(c0):  # a chunk's 256 scaled scores of every query, -1e30 past S
        n = min(F32_CHUNK, s - c0)
        sc = torch.full((*q.shape[:-1], F32_CHUNK), -1e30)
        sc[..., :n] = _dots(q, k[..., c0:c0 + n, :]) * 0.125
        return sc

    m = torch.stack([scores(c0).amax(-1) for c0 in chunks], -1).amax(-1, keepdim=True)
    l = torch.zeros_like(m)
    for c0 in chunks:  # pass 2, as softmax_rows sums a chunk
        t = torch.zeros(*q.shape[:-1], 32)
        sc = torch.exp(scores(c0) - m)
        for j in range(0, F32_CHUNK, 32):
            t = t + sc[..., j:j + 32]
        l = l + _warp_sum(t)[..., None]
    p = torch.cat([torch.exp(scores(c0) - m) / l for c0 in chunks], -1)[..., :s]
    o = _runs_product(p, v, s, F32_CHUNK, 1, 32)
    dp = _dots(do, v)
    ds = p * (dp - _chunk_lane_sum(dp, p)[..., None])  # passes 3 and 4
    dq = _runs_product(ds, k, s, F32_CHUNK, 1, 32) * 0.125
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dv = _runs_product(pt, do, s, F32_CHUNK, 1, 32)
    dk = _runs_product(dst, q, s, F32_CHUNK, 1, 32) * 0.125
    return p, o, dq, dk, dv


def _onepass_flash_fwd(q, k, v):
    return _tokens(_onepass_f32(*(_heads(t) for t in (q, k, v)), _heads(v))[1], q.dtype)


def _onepass_flash_bwd(q, k, v, do):
    return tuple(_tokens(t, q.dtype) for t in _onepass_f32(*(_heads(t) for t in (q, k, v, do)))[2:])


@pytest.mark.parametrize("s", [290, 577])
def test_fp32_long_order_matches_pallas(s, monkeypatch):
    """mha_pallas in fp32 with its twins replaced by the emulation of the
    one-pass route's order of sums, against the JAX mha_pallas in interpret
    mode (fp32 bounds of section 1); and against the emulation of the
    multi-pass route: p bit for bit, o, dq, dk, dv within fp32 reassociation
    (1e-5 of each output's largest magnitude). One image, one head; S = 577
    is ViT-Base/16-384's length."""
    q, k, v, cot = _attention_operands((1, s, 1, 64), s + 5)
    ref, ref_g = _jax_mha(q, k, v, cot, jnp.float32)
    monkeypatch.setattr(fa, "flash_attention_plain", _onepass_flash_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _onepass_flash_bwd)
    got, got_g = _port_mha(q, k, v, cot, torch.float32)
    _close_mha(got, got_g, ref, ref_g, "float32")
    heads = [_heads(torch.from_numpy(t)) for t in (q, k, v, cot)]
    one, multi = _onepass_f32(*heads), _multipass_f32(*heads)
    assert torch.equal(one[0], multi[0]), "p"
    for name, a, b in zip(("o", "dq", "dk", "dv"), one[1:], multi[1:]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale, (name, float((a - b).abs().max()))


# ---------------------------------------------------------------------------
# 3. two SSP steps at 272 px (S = 290)
# ---------------------------------------------------------------------------

def _port_cfg(jax_cfg):
    d = dataclasses.asdict(jax_cfg)
    return tcfg.SSPConfig(
        vit=tcfg.ViTConfig(**d.pop("vit")),
        data=tcfg.DataConfig(**{**d["data"], "augment": tcfg.AugmentConfig(
            **d["data"]["augment"])}),
        mesh=tcfg.MeshConfig(**d.pop("mesh")),
        **{k: v for k, v in d.items() if k != "data"},
    )


def test_ssp_trajectory_at_272px_matches_jax(tiny_ssp):
    """Two optimizer steps (2 microbatches of 4, Adam, EMA) of the port's
    "fused" path at image_size 272 (17 x 17 patches + cls = 290 tokens,
    D = 64, one head of 64) against the JAX trainer from the same weights on
    the same batches, augmentation and dropout off: losses within 3e-5,
    parameters within 2e-5 (tests/test_torch_train.py's bounds)."""
    vit = JViTConfig(image_size=272, patch_size=16, hidden_size=64, num_layers=2,
                     num_heads=1, mlp_dim=128)
    assert vit.seq_len == 290
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
    ds = jax_synthetic(image_size=28, split_sizes={"train": 16}, seed=7)
    eff = jcfg.effective_batch
    for step in range(2):
        batch = ds.images[step * eff:(step + 1) * eff]
        ref = float(jt.train_step(batch, jax.random.key(step))["loss"])
        got = float(pt.train_step(batch, (0, step))["loss"])
        assert math.isfinite(got)
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0, err_msg=f"step {step}")
    ref = jax.tree_util.tree_flatten_with_path(jax.device_get(jt.state.params))[0]
    got = ckpt._flatten(pt.state.params)
    assert got["online/pos_embed"].shape[-3:] == (1, 290, 64)
    for path, leaf in ref:
        key = jckpt._path_key(path)
        np.testing.assert_allclose(got[key], np.asarray(leaf), atol=2e-5, rtol=0, err_msg=key)
