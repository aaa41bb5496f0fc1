"""The backward halves' order of operations on the CPU.

1. The split layer backward's fp32 twins (`mlp_bwd_plain` then
   `attn_bwd_plain`, and `merged_bwd_plain`) against the JAX package's
   Pallas kernels in interpret mode (`_layer_bwd`), at the tiny geometry of
   tests/conftest.py. In fp32 every rounding point is the identity, so the
   two differ by float32 reassociation only: atol 2e-4, as
   tests/test_fused_block.py holds the fused kernels to XLA.

2. A plain-torch emulation of the bf16 Hopper kernels' order of sums
   (csrc/mlp_bwd.cuh, csrc/attn_bwd.cuh, and csrc/merged_bwd.cu, which runs
   the two halves' stages with their reductions deferred to one pass at the
   end): every GEMM summed in fp32 over
   64-wide chunks of its reduction index in order (dy2 over hidden chunks,
   dy1 over chunks of 3 D), the weight gradients and bias sums as split-K
   partials over 64-row token chunks added split by split in a fixed order,
   and the LayerNorm parameter gradients as per-16-row partials. It rounds
   at the kernels' points (bf16 y, m1, g, gg, dg, dm1, datt, dS, dqkv; fp32
   dy; bf16 dx2 / dx) and is held against `_mlp_bwd_math` / `_attn_bwd_math`
   in bf16 with the bf16 tolerance of tests/test_torch_backward.py: both
   round at the same points and sum in other orders, so a value near a
   rounding boundary lands one bf16 step away (max 4% of the output's
   largest magnitude, mean 0.5%). The merged emulation must equal the split
   pair's bit for bit (the same stages and orders of sums), and is held
   against `_layer_bwd(..., merged=True)` in interpret mode at that
   tolerance.

   The wide route's cases (D = 384, 768 and 1024: ViT-Small, ViT-Base and
   ViT-Large) emulate its stage structure: every product whose N is D (dy,
   datt, the weight gradients) in 192-column tiles (256 at D = 1024), dy
   through fp32 scratch, then the
   row-wise LayerNorm backward of 16-row warps with its per-16-row
   partials, the weight gradients' splits as csrc/wgrad.cuh chooses them
   for those launches.
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


def _mm_chunked(a, b, k_chunk, nt=None):
    """a @ b in fp32, the reduction in k_chunk-wide chunks taken in order;
    with `nt`, one nt-column tile of the output at a time (the wide route's
    tiles of wgmma's N)."""
    if nt is not None and nt < b.shape[1]:
        return torch.cat([_mm_chunked(a, b[:, n:n + nt], k_chunk)
                          for n in range(0, b.shape[1], nt)], dim=1)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], k_chunk):
        acc = acc + a[:, k:k + k_chunk] @ b[k:k + k_chunk]
    return acc


def _split_k(a, b, rows, cps, nt=None):
    """The wgrad kernel's split partials of [a^T b; column sums of a; column
    sums of b] over the token rows: `rows`-row chunks summed in order within
    a split of `cps` chunks, one partial per split; with `nt`, a^T b in
    nt-column tiles of b."""
    parts = []
    step = rows * cps
    for s0 in range(0, a.shape[0], step):
        acc, sa, sb = 0, 0, 0
        for r in range(s0, min(s0 + step, a.shape[0]), rows):
            acc = acc + _mm_chunked(a[r:r + rows].t(), b[r:r + rows], rows, nt)
            sa = sa + a[r:r + rows].sum(0)
            sb = sb + b[r:r + rows].sum(0)
        parts.append((acc, sa, sb))
    return parts


def _ln_bwd_rows(dy, x, scale, resid, part_rows):
    """The EPI_LNBWD epilogue: fp32 statistics of x, dx rounded with the
    residual, and the parameter gradients' per-`part_rows` partials."""
    xhat, rstd = fb._ln_stats(x, EPS)
    dxhat = dy * scale
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    parts = [((dy[r:r + part_rows] * xhat[r:r + part_rows]).sum(0), dy[r:r + part_rows].sum(0))
             for r in range(0, dy.shape[0], part_rows)]
    return _bf(resid + dx), parts


def _take(pending):
    """The reductions still to be taken, {name: (partials, which, transpose)},
    each its partials' entry `which` added in order (reduce_all_kernel's
    fixed order; the kernel's tree over many parts is another fixed order)."""
    out = {}
    for n, (parts, which, tr) in pending.items():
        acc = parts[0][which]
        for p in parts[1:]:
            acc = acc + p[which]
        out[n] = acc.t() if tr else acc
    return out


def _mlp_bwd_stages(x2, dout, w, fast, k_chunk, rows, cps, nt=None):
    """The MLP half's stages: dx2 and its reductions still to be taken.
    `nt`: the wide route's N tiles of the products whose N is D."""
    xhat, _ = fb._ln_stats(x2, EPS)
    y2 = _bf(xhat * w["ln2_scale"] + w["ln2_bias"])
    m1 = _bf(_mm_chunked(y2, _bf(w["w1"]), k_chunk) + _bf(w["b1"]))
    g = _bf(fb.gelu(m1, fast))
    gg = _bf(fb.gelu_grad(m1, fast))
    dg = _bf(_mm_chunked(dout, _bf(w["w2"]).t(), k_chunk))
    dm1 = _bf(dg * gg)
    # over 64-wide hidden chunks; on the wide route into fp32 scratch
    dy2 = _mm_chunked(dm1, _bf(w["w1"]).t(), k_chunk, nt).float()
    dx2, ln = _ln_bwd_rows(dy2, x2, w["ln2_scale"], dout, 16)
    p2, p1 = _split_k(g, dout, rows, cps, nt), _split_k(dm1, y2, rows, cps, nt)
    return dx2, {"ln2_scale": (ln, 0, False), "ln2_bias": (ln, 1, False),
                 "w1": (p1, 0, True), "b1": (p1, 1, False),
                 "w2": (p2, 0, False), "b2": (p2, 2, False)}


def _attn_bwd_stages(x, dx2, w, heads, b, s, k_chunk, rows, cps, nt=None):
    """The attention half's stages: dx and its reductions still to be taken.
    `nt`: the wide route's N tiles of the products whose N is D."""
    d = x.shape[1]
    xhat, _ = fb._ln_stats(x, EPS)
    y1 = _bf(xhat * w["ln1_scale"] + w["ln1_bias"])
    qkv = _bf(_mm_chunked(y1, _bf(w["wqkv"]), k_chunk) + _bf(w["bqkv"]))
    datt = _bf(_mm_chunked(dx2, _bf(w["wo"]).t(), k_chunk, nt))
    att, dqkv = fb._attention_bwd(qkv.to(torch.bfloat16).reshape(b, s, 3 * d),
                                  datt.to(torch.bfloat16).reshape(b, s, d), heads)
    att, dqkv = att.float().reshape(-1, d), dqkv.float().reshape(-1, 3 * d)
    # over chunks of 3 D; on the wide route into fp32 scratch
    dy1 = _mm_chunked(dqkv, _bf(w["wqkv"]).t(), k_chunk, nt).float()
    dx, ln = _ln_bwd_rows(dy1, x, w["ln1_scale"], dx2, 16)
    po, pq = _split_k(att, dx2, rows, cps, nt), _split_k(dqkv, y1, rows, cps, nt)
    return dx, {"ln1_scale": (ln, 0, False), "ln1_bias": (ln, 1, False),
                "wqkv": (pq, 0, True), "bqkv": (pq, 1, False),
                "wo": (po, 0, False), "bo": (po, 2, False)}


def _mlp_bwd_emulated(x2, dout, w, fast, k_chunk, rows, cps, nt=None):
    """csrc/mlp_bwd.cuh's bf16 route: the stages, then its reductions."""
    dx2, pending = _mlp_bwd_stages(x2, dout, w, fast, k_chunk, rows, cps, nt)
    return dx2, _take(pending)


def _attn_bwd_emulated(x, dx2, w, heads, b, s, k_chunk, rows, cps, nt=None):
    """csrc/attn_bwd.cuh's bf16 route: the stages, then its reductions."""
    dx, pending = _attn_bwd_stages(x, dx2, w, heads, b, s, k_chunk, rows, cps, nt)
    return dx, _take(pending)


def _merged_bwd_emulated(x, x2, dout, w, fast, heads, b, s, k_chunk, rows, cps, nt=None):
    """csrc/merged_bwd.cu's bf16 routes (the kit's and the wide one): the
    MLP half's stages, the attention half's on its dx2, then all six
    reductions in one pass."""
    dx2, pending = _mlp_bwd_stages(x2, dout, w, fast, k_chunk, rows, cps, nt)
    dx, more = _attn_bwd_stages(x, dx2, w, heads, b, s, k_chunk, rows, cps, nt)
    return dx, _take({**pending, **more})


def _close_bf16(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    mx = float(np.abs(ref).max()) or 1.0
    err = np.abs(got - ref)
    assert err.max() <= 4e-2 * mx, (what, float(err.max()), mx)
    assert err.mean() <= 5e-3 * mx, (what, float(err.mean()), mx)


# (reduction chunk, token rows per chunk, chunks per split, N tile, D,
# heads, mlp): the kit's order (64, 64, ...) and small ones that make several
# chunks and splits at D = 64; the wide route's 192-column N tiles at D = 384
# and 768, and its 256-column tiles at D = 1024 (ViT-Large; at these 33
# token rows one 64-row chunk: the splits csrc/wgrad.cuh takes for the wide
# pairs hold several, as the small orders emulate)
ORDERS = [(64, 64, 1, None, 64, 2, 128), (16, 4, 2, None, 64, 2, 128),
          (32, 8, 3, None, 64, 2, 128), (64, 64, 1, 192, 384, 6, 1536),
          (64, 8, 2, 192, 768, 12, 3072), (64, 64, 1, 256, 1024, 16, 4096)]
ORDER_IDS = ["kernel", "k16_r4_s2", "k32_r8_s3", "wide_d384", "wide_d768_r8_s2", "wide_d1024"]


def _w_std(d):
    """W1's std: the gelu inputs keep D = 64's spread at every width."""
    return 0.4 * (64 / d) ** 0.5


@pytest.mark.parametrize("order", ORDERS, ids=ORDER_IDS)
@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
def test_mlp_bwd_kernel_order_matches_pallas_math(order, fast, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    *order, d, _, mlp = order
    b, s, sp = 3, 11, 16
    rng = np.random.default_rng(2)
    w = _weights(rng, d, mlp, _w_std(d))
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


@pytest.mark.parametrize("order", ORDERS, ids=ORDER_IDS)
def test_attn_bwd_kernel_order_matches_pallas_math(order):
    *order, d, heads, mlp = order
    b, s, sp = 3, 11, 16
    rng = np.random.default_rng(3)
    w = _weights(rng, d, mlp)
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


_MERGED_REF = {}  # the interpret-mode merged kernel's result per gelu form and width


def _merged_pallas(x, x2, dout, w, heads, s, sp, fast):
    key = (fast, x.shape[-1])
    if key not in _MERGED_REF:
        jw = {k: jnp.asarray(v, jnp.float32 if k.startswith("ln") else jnp.bfloat16)
              for k, v in w.items()}
        dx, g = jfb._layer_bwd(*(_pad(a, sp).astype(jnp.bfloat16) for a in (x, x2, dout)), jw,
                               heads, s, sp, EPS, 2, True, merged=True)
        _MERGED_REF[key] = (np.asarray(jnp.asarray(dx).astype(jnp.float32))[:, :s],
                            {n: np.asarray(t) for n, t in g.items()})
    return _MERGED_REF[key]


@pytest.mark.parametrize("order", ORDERS, ids=ORDER_IDS)
@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
def test_merged_kernel_order_is_the_split_pair_and_matches_pallas(order, fast, monkeypatch):
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    *order, d, heads, mlp = order
    b, s, sp = 3, 11, 16
    rng = np.random.default_rng(4)
    w = _weights(rng, d, mlp, _w_std(d))
    x, x2 = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(2))
    dout = (0.1 * rng.standard_normal((b, s, d))).astype(np.float32)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    tx, tx2, tg = (_bf(torch.from_numpy(a).reshape(-1, d)) for a in (x, x2, dout))
    dx, got = _merged_bwd_emulated(tx, tx2, tg, tw, fast, heads, b, s, *order)
    dx2, split = _mlp_bwd_emulated(tx2, tg, tw, fast, *order)
    sdx, agrads = _attn_bwd_emulated(tx, dx2, tw, heads, b, s, *order)
    split.update(agrads)
    assert torch.equal(dx, sdx)
    for n in fb.WEIGHT_NAMES:
        assert torch.equal(got[n], split[n]), n
    ref_dx, ref_g = _merged_pallas(x, x2, dout, w, heads, s, sp, fast)
    _close_bf16(dx.reshape(b, s, d), ref_dx, "dx")
    for n in fb.WEIGHT_NAMES:
        _close_bf16(got[n], ref_g[n].reshape(w[n].shape), n)
