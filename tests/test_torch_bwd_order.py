"""The backward halves' order of operations on the CPU.

1. The split layer backward's fp32 twins (`mlp_bwd_plain` then
   `attn_bwd_plain`, and `merged_bwd_plain`) against the JAX package's
   Pallas kernels in interpret mode (`_layer_bwd`), at the tiny geometry of
   tests/conftest.py. In fp32 every rounding point is the identity, so the
   two differ by float32 reassociation only: atol 2e-4, as
   tests/test_fused_block.py holds the fused kernels to XLA.

2. A plain-torch emulation of the bf16 Hopper kernels' order of sums
   (csrc/mlp_bwd.cuh, csrc/attn_bwd.cuh): every GEMM summed in fp32 over
   64-wide chunks of its reduction index in order (dy2 over hidden chunks,
   dy1 over chunks of 3 D), the weight gradients and bias sums as split-K
   partials over 64-row token chunks added split by split in a fixed order,
   and the LayerNorm parameter gradients as per-16-row partials. It rounds
   at the kernels' points (bf16 y, m1, g, gg, dg, dm1, datt, dS, dqkv; fp32
   dy; bf16 dx2 / dx) and is held against `_mlp_bwd_math` / `_attn_bwd_math`
   in bf16 with the bf16 tolerance of tests/test_torch_backward.py: both
   round at the same points and sum in other orders, so a value near a
   rounding boundary lands one bf16 step away (max 4% of the output's
   largest magnitude, mean 0.5%).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu_torch.ops import fused_block as fb

jfb = importlib.import_module("vit2spn_tpu.ops.fused_block")
torch.set_num_threads(1)

EPS = 1e-12


def _weights(rng, d, mlp, std_w1=0.4):
    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "ln1_scale": 1.0 + n(d, std=0.1), "ln1_bias": n(d, std=0.1),
        "wqkv": n(d, 3 * d, std=0.1), "bqkv": n(3 * d, std=0.05),
        "wo": n(d, d, std=0.1), "bo": n(d, std=0.05),
        "ln2_scale": 1.0 + n(d, std=0.1), "ln2_bias": n(d, std=0.1),
        "w1": n(d, mlp, std=std_w1), "b1": n(mlp, std=0.05),
        "w2": n(mlp, d, std=0.1), "b2": n(d, std=0.05),
    }


def _pad(x, sp):
    b, s, d = x.shape
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, sp - s), (0, 0)))


# ---------------------------------------------------------------------------
# 1. fp32 twins vs interpret-mode Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merged", [False, True], ids=["split", "merged"])
def test_layer_bwd_fp32_twins_match_pallas_interpret(tiny_vit, merged, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "0")
    d, heads, mlp = tiny_vit.hidden_size, tiny_vit.num_heads, tiny_vit.mlp_dim
    b, s, sp = 2, 5, 16
    rng = np.random.default_rng(0)
    w = _weights(rng, d, mlp)
    x, x2 = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((b, s, d))).astype(np.float32)
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


# ---------------------------------------------------------------------------
# 2. the bf16 kernels' order of sums
# ---------------------------------------------------------------------------

def _bf(t):
    return t.to(torch.bfloat16).float()


def _mm_chunked(a, b, k_chunk):
    """a @ b in fp32, the reduction in k_chunk-wide chunks taken in order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], k_chunk):
        acc = acc + a[:, k:k + k_chunk] @ b[k:k + k_chunk]
    return acc


def _split_k(a, b, rows, cps):
    """[a^T b; column sums of a; column sums of b] over the token rows as the
    wgrad kernel takes them: `rows`-row chunks summed in order within a
    split of `cps` chunks, the splits' partials then added in order."""
    parts = []
    step = rows * cps
    for s0 in range(0, a.shape[0], step):
        acc, sa, sb = 0, 0, 0
        for r in range(s0, min(s0 + step, a.shape[0]), rows):
            acc = acc + a[r:r + rows].t() @ b[r:r + rows]
            sa = sa + a[r:r + rows].sum(0)
            sb = sb + b[r:r + rows].sum(0)
        parts.append((acc, sa, sb))
    out = [parts[0][i] for i in range(3)]
    for p in parts[1:]:
        out = [o + q for o, q in zip(out, p)]
    return out


def _ln_bwd_rows(dy, x, scale, resid, part_rows):
    """The EPI_LNBWD epilogue: fp32 statistics of x, dx rounded with the
    residual, the parameter gradients from per-`part_rows` partials added
    in order."""
    xhat, rstd = fb._ln_stats(x, EPS)
    dxhat = dy * scale
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    gs, gb = 0, 0
    for r in range(0, dy.shape[0], part_rows):
        gs = gs + (dy[r:r + part_rows] * xhat[r:r + part_rows]).sum(0)
        gb = gb + dy[r:r + part_rows].sum(0)
    return _bf(resid + dx), gs, gb


def _mlp_bwd_emulated(x2, dout, w, fast, k_chunk, rows, cps):
    xhat, _ = fb._ln_stats(x2, EPS)
    y2 = _bf(xhat * w["ln2_scale"] + w["ln2_bias"])
    m1 = _bf(_mm_chunked(y2, _bf(w["w1"]), k_chunk) + _bf(w["b1"]))
    g = _bf(fb.gelu(m1, fast))
    gg = _bf(fb.gelu_grad(m1, fast))
    dg = _bf(_mm_chunked(dout, _bf(w["w2"]).t(), k_chunk))
    dm1 = _bf(dg * gg)
    dy2 = _mm_chunked(dm1, _bf(w["w1"]).t(), k_chunk)  # over 64-wide hidden chunks
    dx2, gs, gb = _ln_bwd_rows(dy2, x2, w["ln2_scale"], dout, 16)
    dw2, _, db2 = _split_k(g, dout, rows, cps)
    dw1t, db1, _ = _split_k(dm1, y2, rows, cps)
    return dx2, {"ln2_scale": gs, "ln2_bias": gb, "w1": dw1t.t(), "b1": db1,
                 "w2": dw2, "b2": db2}


def _attn_bwd_emulated(x, dx2, w, heads, b, s, k_chunk, rows, cps):
    d = x.shape[1]
    xhat, _ = fb._ln_stats(x, EPS)
    y1 = _bf(xhat * w["ln1_scale"] + w["ln1_bias"])
    qkv = _bf(_mm_chunked(y1, _bf(w["wqkv"]), k_chunk) + _bf(w["bqkv"]))
    datt = _bf(_mm_chunked(dx2, _bf(w["wo"]).t(), k_chunk))
    att, dqkv = fb._attention_bwd(qkv.to(torch.bfloat16).reshape(b, s, 3 * d),
                                  datt.to(torch.bfloat16).reshape(b, s, d), heads)
    att, dqkv = att.float().reshape(-1, d), dqkv.float().reshape(-1, 3 * d)
    dy1 = _mm_chunked(dqkv, _bf(w["wqkv"]).t(), k_chunk)  # over chunks of 3 D
    dx, gs, gb = _ln_bwd_rows(dy1, x, w["ln1_scale"], dx2, 16)
    dwo, _, dbo = _split_k(att, dx2, rows, cps)
    dwqkv_t, dbqkv, _ = _split_k(dqkv, y1, rows, cps)
    return dx, {"ln1_scale": gs, "ln1_bias": gb, "wqkv": dwqkv_t.t(), "bqkv": dbqkv,
                "wo": dwo, "bo": dbo}


def _close_bf16(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    mx = float(np.abs(ref).max()) or 1.0
    err = np.abs(got - ref)
    assert err.max() <= 4e-2 * mx, (what, float(err.max()), mx)
    assert err.mean() <= 5e-3 * mx, (what, float(err.mean()), mx)


# (reduction chunk, token rows per chunk, chunks per split): the kernels'
# (64, 64, ...) and small ones that make several chunks and splits here
ORDERS = [(64, 64, 1), (16, 4, 2), (32, 8, 3)]


@pytest.mark.parametrize("order", ORDERS, ids=["kernel", "k16_r4_s2", "k32_r8_s3"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
def test_mlp_bwd_kernel_order_matches_pallas_math(order, fast, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    b, s, sp, d, mlp = 3, 11, 16, 64, 128
    rng = np.random.default_rng(2)
    w = _weights(rng, d, mlp)
    x2 = rng.standard_normal((b, s, d)).astype(np.float32)
    dout = (0.1 * rng.standard_normal((b, s, d))).astype(np.float32)
    jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jnp.bfloat16)
          for k, v in w.items()}
    ref_dx2, ref_g = jfb._mlp_bwd_math(
        _pad(x2, sp).astype(jnp.bfloat16).reshape(b * sp, d),
        _pad(dout, sp).astype(jnp.bfloat16).reshape(b * sp, d), jw, jnp.bfloat16, EPS)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got_dx2, got = _mlp_bwd_emulated(_bf(torch.from_numpy(x2).reshape(-1, d)),
                                     _bf(torch.from_numpy(dout).reshape(-1, d)), tw, fast,
                                     *order)
    ref_dx2 = np.asarray(jnp.asarray(ref_dx2).astype(jnp.bfloat16).astype(jnp.float32))
    _close_bf16(got_dx2.reshape(b, s, d), ref_dx2.reshape(b, sp, d)[:, :s], "dx2")
    for n in fb.MLP_NAMES:
        _close_bf16(got[n], ref_g[n], n)


@pytest.mark.parametrize("order", ORDERS, ids=["kernel", "k16_r4_s2", "k32_r8_s3"])
def test_attn_bwd_kernel_order_matches_pallas_math(order):
    b, s, sp, d, heads = 3, 11, 16, 64, 2
    rng = np.random.default_rng(3)
    w = _weights(rng, d, 128)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dx2 = (0.1 * rng.standard_normal((b, s, d))).astype(np.float32)
    jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jnp.bfloat16)
          for k, v in w.items()}
    ref_dx, ref_g = jfb._attn_bwd_math(
        _pad(x, sp).astype(jnp.bfloat16).reshape(b * sp, d),
        _pad(dx2, sp).astype(jnp.bfloat16).reshape(b * sp, d), jw, b, sp, d, heads, s, EPS,
        jnp.bfloat16)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got_dx, got = _attn_bwd_emulated(_bf(torch.from_numpy(x).reshape(-1, d)),
                                     _bf(torch.from_numpy(dx2).reshape(-1, d)), tw, heads, b, s,
                                     *order)
    ref_dx = np.asarray(jnp.asarray(ref_dx).astype(jnp.bfloat16).astype(jnp.float32))
    _close_bf16(got_dx.reshape(b, s, d), ref_dx.reshape(b, sp, d)[:, :s], "dx")
    for n in fb.ATTN_NAMES:
        _close_bf16(got[n], ref_g[n], n)
