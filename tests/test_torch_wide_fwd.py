"""The forward layer's wide route (D > FUSED_MLP_MAX_D: ViT-Small, ViT-Base)
in csrc/layer_fwd.cuh: seven launches a layer (LN1, the QKV GEMM, the
attention, the Wo GEMM with the residual, LN2, the W1 GEMM with gelu, the W2
GEMM with the residual), each GEMM of csrc/tile_gemm.cuh summing its K as one
fp32 chain of 16-deep k-steps.

On the CPU the CUDA kernels cannot run, so (a) emulates the route's order of
sums and rounding points in plain torch and holds it against the JAX
package's `_block_fwd_math` at both zoo widths, and (b) checks the scratch
the wrapper hands the C entry points. The kernels themselves are held
against their plain twins on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_block import _kernel_order_attention
from vit2spn_tpu.ops.fused_block import WEIGHT_NAMES, _block_fwd_math
from vit2spn_tpu_torch.ops import fused_block as fb

torch.set_num_threads(1)

LAYERS, B, S, EPS = 2, 2, 17, 1e-12
WIDTHS = {"vit_small": (384, 6, 1536), "vit_base": (768, 12, 3072)}


def _weights(d, mlp, seed):
    """Stacked bf16 block weights (LN params fp32) and a bf16 input, scaled by
    fan-in so the residual stream stays near unit size over the layers and
    the MLP pre-activations reach where the two gelu forms differ."""
    rng = np.random.default_rng(seed)

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    ws = {
        "ln1_scale": 1.0 + n(LAYERS, d, std=0.1), "ln1_bias": n(LAYERS, d, std=0.1),
        "wqkv": n(LAYERS, d, 3 * d, std=d ** -0.5), "bqkv": n(LAYERS, 3 * d, std=0.05),
        "wo": n(LAYERS, d, d, std=0.5 * d ** -0.5), "bo": n(LAYERS, d, std=0.05),
        "ln2_scale": 1.0 + n(LAYERS, d, std=0.1), "ln2_bias": n(LAYERS, d, std=0.1),
        "w1": n(LAYERS, d, mlp, std=2.0 * d ** -0.5), "b1": n(LAYERS, mlp, std=0.05),
        "w2": n(LAYERS, mlp, d, std=0.5 * mlp ** -0.5), "b2": n(LAYERS, d, std=0.05),
    }
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    bf = torch.bfloat16
    wt = tuple(torch.from_numpy(ws[k]).to(torch.float32 if k.startswith("ln") else bf)
               for k in WEIGHT_NAMES)
    return torch.from_numpy(x).to(bf), wt


def _ksteps(a, b):
    """a @ b as tile_gemm sums it: one fp32 chain of 16-deep k-steps in order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16].float() @ b[k:k + 16].float()
    return acc


def _wide_route(x, wt, heads, fast):
    """The seven launches' function per layer: y1 and y2 bf16 from fp32
    statistics (ln_rows), bf16 qkv, the attention stage in its order of sums,
    fp32 x2 = (x + att Wo) + bo, g = bf16(gelu(y2 W1 + b1)) over the whole
    mlp, out = bf16((x2 + g W2) + b2)."""
    b, s, d = x.shape
    bf = torch.bfloat16
    h = x.reshape(b * s, d)
    for l in range(wt[0].shape[0]):
        w = {n: t[l] for n, t in zip(WEIGHT_NAMES, wt)}
        y1 = fb._ln_fwd(h, w["ln1_scale"], w["ln1_bias"], EPS).to(bf)
        qkv = (_ksteps(y1, w["wqkv"]) + w["bqkv"].float()).to(bf)
        q, k, v = (t.reshape(b, s, heads, d // heads) for t in qkv.split(d, dim=-1))
        att = _kernel_order_attention(q, k, v).reshape(b * s, d)
        x2 = (h.float() + _ksteps(att, w["wo"])) + w["bo"].float()
        y2 = fb._ln_fwd(x2, w["ln2_scale"], w["ln2_bias"], EPS).to(bf)
        g = fb.gelu(_ksteps(y2, w["w1"]) + w["b1"].float(), fast).to(bf)
        h = ((x2 + _ksteps(g, w["w2"])) + w["b2"].float()).to(bf)
    return h.reshape(b, s, d)


def _jax_layers(x, wt, heads):
    """The layers through the JAX package's `_block_fwd_math` (bf16 residual
    stream between layers, as its backbone kernel keeps it)."""
    b, s, d = x.shape
    h = jnp.asarray(x.float().numpy(), jnp.bfloat16).reshape(b * s, d)
    for l in range(wt[0].shape[0]):
        w = {n: jnp.asarray(t[l].float().numpy(), jnp.float32 if n.startswith("ln")
                            else jnp.bfloat16) for n, t in zip(WEIGHT_NAMES, wt)}
        h = _block_fwd_math(h, w, b, s, d, heads, s, EPS, jnp.bfloat16)["out"].astype(
            jnp.bfloat16)
    return np.asarray(h.astype(jnp.float32)).reshape(b, s, d)


@pytest.mark.parametrize("fast", [False, True], ids=["exact_gelu", "fast_gelu"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_wide_route_order_matches_block_fwd_math(width, fast, monkeypatch):
    """(a) The wide route's order of sums and rounding points against
    `_block_fwd_math` on the CPU, 2 layers at ViT-Small's and ViT-Base's
    widths, with the bf16 tests' tolerance (atol 3e-2, rtol 2e-2): the order
    of sums moves no output further than a bf16 step."""
    monkeypatch.setenv("VIT2SPN_FAST_GELU", "1" if fast else "0")
    d, heads, mlp = WIDTHS[width]
    x, wt = _weights(d, mlp, seed=d + int(fast))
    got = _wide_route(x, wt, heads, fast)
    ref = _jax_layers(x, wt, heads)
    assert got.shape == (B, S, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2, rtol=2e-2)


def _leading_pointers(argtypes) -> int:
    n = 0
    while argtypes[n] is fb._P:
        n += 1
    return n


@pytest.mark.parametrize("wide", [False, True], ids=["narrow_d64_to_256", "wide_d384_512_768"])
def test_layer_scratch_matches_entry_points(wide):
    """(b) `_layer_scratch` gives the C entry points' scratch in their order
    (qkv, att, y, x2, g: after x, out, the optional stacks and the 12 weight
    pointers), in the shapes and dtypes the layer takes, at every D (at
    D <= 256 the head_dim-64 layer reads only qkv and att)."""
    sig = fb._SIGNATURES
    assert _leading_pointers(sig["backbone_fwd"]["vit2spn_backbone_fwd"][0]) == 4 + 12 + 5
    assert _leading_pointers(sig["layer_fwd"]["vit2spn_layer_fwd"][0]) == 3 + 12 + 5
    m = 2 * 197
    bf, f32 = torch.bfloat16, torch.float32
    for d in ((384, 512, 768) if wide else (64, 128, 192, 256)):
        mlp = 4 * d
        scratch = fb._layer_scratch(m, d, mlp, "cpu")
        assert len(scratch) == 5
        assert (d > fb.FUSED_MLP_MAX_D) == wide
        want = [((m, 3 * d), bf), ((m, d), bf), ((m, d), bf), ((m, d), f32), ((m, mlp), bf)]
        for t, (shape, dtype) in zip(scratch, want, strict=True):
            assert tuple(t.shape) == shape and t.dtype == dtype and t.is_contiguous()
