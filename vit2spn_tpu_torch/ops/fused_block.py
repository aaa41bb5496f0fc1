"""The fused ViT block kernels: whole-backbone and one-layer forwards, the
split and merged layer backwards, their plain twins, their wrappers, and the
autograd Functions that join them.

Port of `vit2spn_tpu/ops/fused_block.py`: `fused_backbone` and its
custom_vjp (the Pallas kernels `_backbone_fwd_kernel`, `_mlp_bwd_kernel`,
`_attn_bwd_kernel` and, under VIT2SPN_MERGED_BWD=1, `_merged_bwd_kernel`),
and the per-layer `fused_block` (`_fwd_kernel`, its backward the split
halves). Per kernel three pieces:

  * a plain PyTorch twin with the Pallas kernel's rounding points
    (`backbone_forward_plain` and `layer_forward_plain` after
    `_block_fwd_math`: bf16 LN outputs before their GEMMs, bf16 qkv, bf16
    softmax probabilities before P.V, fp32 x2 inside the layer, a bf16
    residual stream between layers, fp32 gelu then bf16; `mlp_bwd_plain`
    after `_mlp_bwd_math`, `attn_bwd_plain` after `_attn_bwd_math` and
    `merged_bwd_plain`, the two in a row: bf16 m1, dm1, dx2, datt, dS and
    dqkv, fp32 weight gradients). Matmuls take compute-dtype inputs and
    accumulate in fp32.
  * the CUDA kernel in `csrc/<name>.cu` (several launches on the current
    stream), built on first use (ops/cuda_build.py).
  * the wrapper (`fused_backbone`, `layer_fwd`, `mlp_bwd`, `attn_bwd`,
    `merged_bwd`). For CPU tensors it runs the plain twin; for CUDA tensors
    it launches the kernel, or raises on what the kernel does not take. It
    never falls back from CUDA to the plain twin. Like the Pallas bodies,
    which compute in whatever dtype arrives, each kernel takes bf16 or fp32
    (compute_dtype=float32) activations with matmul weights of the same
    dtype: fp32 has its own route in every source (CUDA-core GEMMs and
    attention, every rounding point of the bf16 function the identity). Each counts its kernel
    launches in `.launches` and names them `vit2spn::<name>` for
    torch.profiler, which sums their device time under that range.

Under autograd `fused_backbone` goes through `_FusedBackbone`: its forward
keeps each layer's input (xs) and mid-residual (x2s), its backward runs the
layers in reverse as `_backbone_vjp_bwd`, per layer the MLP half then the
attention half, or `merged_bwd` when VIT2SPN_MERGED_BWD=1 at the time of
the backward call. `fused_block` (one layer, the "fused_layer" path) goes
through `_FusedBlock`: the one-layer kernel forward keeps x and x2, its
backward runs the split halves, as `_fused_bwd`.

Layout: x (B, S, D); backbone weights a tuple of STACKED arrays in
WEIGHT_NAMES order with a leading layer axis — LN params fp32 (L, D), matmul
weights (L, in, out) and biases (L, n) in compute dtype; one layer's weights
the same tuple without the layer axis. Unlike the TPU kernels nothing is
padded to a multiple of 16 tokens in memory: the kernels mask their own pad
keys and queries, so the xs / x2s residual stacks are (L, B, S, D).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from vit2spn_tpu_torch.ops.attention import acc, mha_plain

WEIGHT_NAMES = (
    "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
    "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2",
)
KERNEL_NAME = "backbone_fwd"
# what csrc/backbone_fwd.cu takes: its attention holds a row of scores in
# registers (S <= 256), its LayerNorm a row of D values (D <= 768)
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 256
KERNEL_MAX_D = 768
# widest D whose layer keeps x2, y2 and g inside one block (csrc/layer_fwd.cuh
# FUSED_MLP_MAX_D); above it the layer passes fp32 x2 and g through scratch
FUSED_MLP_MAX_D = 256
# widest D whose bf16 backward halves run the wgmma row-block kit
# (csrc/mlp_bwd.cuh HOPPER_BWD_MAX_D), which keeps dy in registers; above it,
# and in fp32, the halves pass an fp32 dy through scratch
HOPPER_BWD_MAX_D = 256


def fast_gelu_default() -> bool:
    """The gelu form entry points use when the caller does not say: the
    `VIT2SPN_FAST_GELU` variable the JAX package reads ("1" unless set), so
    both packages compute the same thing under one setting."""
    return os.environ.get("VIT2SPN_FAST_GELU", "1") == "1"


def _erf_exact(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (|err| < 1.5e-7), as the JAX
    kernels compute it (not torch.erf)."""
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
            + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_fast(m1: torch.Tensor) -> torch.Tensor:
    """gelu(x) = x*(0.5 + xc*P3(xc^2)/Q3(xc^2)), xc = clip(x, -4.6, 4.6):
    the odd cdf rational of the JAX kernels. The leading x stays unclamped."""
    xc = torch.clamp(m1, -4.6, 4.6)
    s = xc * xc
    p = 3.303320889057693e-05
    p = 0.003819241585880179 + s * p
    p = 0.027416247095983802 + s * p
    p = 0.3989386549977406 + s * p
    q = 0.0011597711855913715
    q = 0.023787000484733943 + s * q
    q = 0.23538129451100157 + s * q
    q = 1.0 + s * q
    return m1 * (0.5 + xc * (p / q))


def gelu(m1: torch.Tensor, fast_gelu: bool) -> torch.Tensor:
    """Exact A&S-erf gelu, or the fast cdf rational."""
    if fast_gelu:
        return _gelu_fast(m1)
    return 0.5 * m1 * (1.0 + _erf_exact(m1 * 0.7071067811865476))


def gelu_grad(m1: torch.Tensor, fast_gelu: bool) -> torch.Tensor:
    """gelu'(x): Phi(x) + x phi(x) with the A&S erf, or the fast odd rational
    0.5 + xc*P4(xc^2)/Q3(xc^2), xc = clip(x, -4.6, 4.6) (`_gelu_grad_fast`)."""
    if not fast_gelu:
        phi = torch.exp(-0.5 * m1 * m1) * 0.3989422804014327
        cdf = 0.5 * (1.0 + _erf_exact(m1 * 0.7071067811865476))
        return cdf + m1 * phi
    xc = torch.clamp(m1, -4.6, 4.6)
    s = xc * xc
    p = 1.8219220945499694e-06
    p = -1.2033074181130153e-05 + s * p
    p = 0.013759530274157408 + s * p
    p = -0.03544238930343691 + s * p
    p = 0.7981352003862573 + s * p
    q = 0.003771008302941207
    q = 0.036972201734621915 + s * q
    q = 0.2904124253896315 + s * q
    q = 1.0 + s * q
    return 0.5 + xc * p / q


def _ln_stats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 layernorm statistics: (xhat, rstd) from the mean, then the mean
    of squared deviations."""
    x32 = acc(x)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mean) * rstd, rstd


def _ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """fp32 layernorm."""
    return _ln_stats(x, eps)[0] * acc(scale) + acc(bias)


def _block_fwd_plain(x: torch.Tensor, w: dict, heads: int, eps: float,
                     fast_gelu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN block with `_block_fwd_math`'s rounding points. Returns
    (out fp32, x2 fp32); x is in compute dtype."""
    dtype = x.dtype
    b, s, d = x.shape
    dh = d // heads
    y1 = _ln_fwd(x, w["ln1_scale"], w["ln1_bias"], eps).to(dtype)
    qkv = (acc(y1) @ acc(w["wqkv"]) + acc(w["bqkv"])).to(dtype)
    q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(d, dim=-1))
    att = mha_plain(q, k, v).reshape(b, s, d)
    o = acc(att) @ acc(w["wo"])
    x2 = acc(x) + o + acc(w["bo"])
    y2 = _ln_fwd(x2, w["ln2_scale"], w["ln2_bias"], eps).to(dtype)
    m1 = acc(y2) @ acc(w["w1"]) + acc(w["b1"])
    g = gelu(m1, fast_gelu).to(dtype)
    m2 = acc(g) @ acc(w["w2"])
    out = x2 + m2 + acc(w["b2"])
    return out, x2


def backbone_forward_plain(x: torch.Tensor, weights: Tuple, heads: int,
                           eps: float, fast_gelu: bool, emit_res: bool = False):
    """All L blocks over x (B, S, D), plain PyTorch, any device.

    Returns out (B, S, D) in x.dtype; with `emit_res` also the per-layer
    inputs xs and mid-residuals x2s, each (L, B, S, D) in x.dtype."""
    layers = weights[0].shape[0]
    h = x
    xs, x2s = [], []
    for l in range(layers):
        w = {n: t[l] for n, t in zip(WEIGHT_NAMES, weights)}
        out, x2 = _block_fwd_plain(h, w, heads, eps, fast_gelu)
        if emit_res:
            xs.append(h)
            x2s.append(x2.to(x.dtype))
        h = out.to(x.dtype)
    if emit_res:
        return h, torch.stack(xs), torch.stack(x2s)
    return h


def layer_forward_plain(x: torch.Tensor, weights: Tuple, heads: int, eps: float,
                        fast_gelu: bool):
    """One block over x (B, S, D), plain PyTorch, any device: the twin of
    csrc/layer_fwd.cu (`_fwd_kernel`). `weights` is one layer's tuple in
    WEIGHT_NAMES order. Returns (out, x2), both in x.dtype."""
    out, x2 = _block_fwd_plain(x, dict(zip(WEIGHT_NAMES, weights)), heads, eps, fast_gelu)
    return out.to(x.dtype), x2.to(x.dtype)


# ---------------------------------------------------------------------------
# Backward: plain twins of `_mlp_bwd_math`, `_attn_bwd_math` and the reverse
# layer loop of `_backbone_vjp_bwd`, with the Pallas kernels' rounding points
# ---------------------------------------------------------------------------

MLP_NAMES = ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
ATTN_NAMES = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A GEMM of compute-dtype operands with fp32 accumulation (fp64 for the
    float64 reference)."""
    return acc(a) @ acc(b)


def _ln_bwd(dy, xhat, rstd, scale):
    """dy: fp32 (N, D) gradient of the LN output; returns (dx, dscale,
    dbias), as `_ln_bwd`."""
    dxhat = dy * acc(scale)
    dx = rstd * (dxhat - torch.mean(dxhat, dim=-1, keepdim=True)
                 - xhat * torch.mean(dxhat * xhat, dim=-1, keepdim=True))
    return dx, torch.sum(dy * xhat, dim=0), torch.sum(dy, dim=0)


def mlp_bwd_plain(x2: torch.Tensor, dout: torch.Tensor, w: dict, eps: float,
                  fast_gelu: bool):
    """Plain twin of csrc/mlp_bwd.cu (`_mlp_bwd_math`): recompute LN2 and the
    MLP from the mid-residual x2, then back through them. x2, dout: (B, S, D)
    in compute dtype; w: one layer's weights by name. Returns (dx2 in
    x2.dtype, {name: fp32 gradient} over MLP_NAMES)."""
    dtype, shape = x2.dtype, x2.shape
    x2 = x2.reshape(-1, shape[-1])
    dout = dout.reshape(-1, shape[-1])
    xhat, rstd = _ln_stats(x2, eps)
    y2 = (xhat * acc(w["ln2_scale"]) + acc(w["ln2_bias"])).to(dtype)
    # the recompute stores m1 in compute dtype (the forward keeps it fp32)
    m1 = acc((_mm(y2, w["w1"]) + acc(w["b1"])).to(dtype))
    g = gelu(m1, fast_gelu).to(dtype)
    gg = gelu_grad(m1, fast_gelu).to(dtype)
    dg = _mm(dout, w["w2"].t()).to(dtype)
    dm1 = (acc(dg) * acc(gg)).to(dtype)
    dx, dscale, dbias = _ln_bwd(_mm(dm1, w["w1"].t()), xhat, rstd, w["ln2_scale"])
    grads = {
        "ln2_scale": dscale, "ln2_bias": dbias,
        "w1": _mm(y2.t(), dm1), "b1": torch.sum(acc(dm1), dim=0),
        "w2": _mm(g.t(), dout), "b2": torch.sum(acc(dout), dim=0),
    }
    return (acc(dout) + dx).to(dtype).reshape(shape), grads


def _attention_bwd(qkv: torch.Tensor, datt: torch.Tensor, heads: int):
    """Recompute-softmax attention and its backward (`_attention` and
    `_attention_bwd`). qkv: (B, S, 3D), datt: (B, S, D), compute dtype.
    Returns (att (B, S, D), dqkv (B, S, 3D)), both in compute dtype."""
    dtype = qkv.dtype
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    scale = 1.0 / (dh ** 0.5)

    def split(t):  # (B, S, D) -> (B, heads, S, dh), fp32
        return acc(t.reshape(b, s, heads, dh).transpose(1, 2))

    def merge(t):
        return t.transpose(1, 2).reshape(b, s, d)

    q, k, v = (split(t) for t in qkv.split(d, dim=-1))
    do = split(datt)
    sc = (q @ k.transpose(-1, -2)) * scale
    p = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    pdt = acc(p.to(dtype))
    att = merge(pdt @ v).to(dtype)
    dp = do @ v.transpose(-1, -2)
    ds = acc((p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))).to(dtype))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = pdt.transpose(-1, -2) @ do
    return att, torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dtype)


def attn_bwd_plain(x: torch.Tensor, dx2: torch.Tensor, w: dict, heads: int,
                   eps: float):
    """Plain twin of csrc/attn_bwd.cu (`_attn_bwd_math`): recompute LN1, QKV
    and attention from the layer input x, then back through them. x, dx2:
    (B, S, D) in compute dtype. Returns (dx in x.dtype, {name: fp32
    gradient} over ATTN_NAMES)."""
    dtype = x.dtype
    b, s, d = x.shape
    x = x.reshape(-1, d)
    dx2 = dx2.reshape(-1, d)
    xhat, rstd = _ln_stats(x, eps)
    y1 = (xhat * acc(w["ln1_scale"]) + acc(w["ln1_bias"])).to(dtype)
    qkv = (_mm(y1, w["wqkv"]) + acc(w["bqkv"])).to(dtype)
    datt = _mm(dx2, w["wo"].t()).to(dtype)
    att, dqkv = _attention_bwd(qkv.reshape(b, s, 3 * d), datt.reshape(b, s, d), heads)
    att, dqkv = att.reshape(-1, d), dqkv.reshape(-1, 3 * d)
    dx, dscale, dbias = _ln_bwd(_mm(dqkv, w["wqkv"].t()), xhat, rstd, w["ln1_scale"])
    grads = {
        "ln1_scale": dscale, "ln1_bias": dbias,
        "wqkv": _mm(y1.t(), dqkv), "bqkv": torch.sum(acc(dqkv), dim=0),
        "wo": _mm(att.t(), dx2), "bo": torch.sum(acc(dx2), dim=0),
    }
    return (acc(dx2) + dx).to(dtype).reshape(b, s, d), grads


def merged_bwd_plain(x: torch.Tensor, x2: torch.Tensor, dout: torch.Tensor, w: dict,
                     heads: int, eps: float, fast_gelu: bool):
    """Plain twin of csrc/merged_bwd.cu (`_merged_bwd_kernel`): `mlp_bwd_plain`
    then `attn_bwd_plain`, dx2 crossing in compute dtype. Returns (dx in
    x.dtype, {name: fp32 gradient} over WEIGHT_NAMES)."""
    dx2, grads = mlp_bwd_plain(x2, dout, w, eps, fast_gelu)
    dx, attn_grads = attn_bwd_plain(x, dx2, w, heads, eps)
    return dx, {**grads, **attn_grads}


def _backbone_backward(xs, x2s, g, weights, layer):
    """The reverse layer loop of `_backbone_vjp_bwd`. `layer(x, x2, dout, w,
    out)` is one layer's backward: it writes the layer's fp32 weight
    gradients into `out` and returns the gradient of its input. Returns (dx,
    fp32 stacked gradients in WEIGHT_NAMES order)."""
    g = g.to(xs.dtype).contiguous()
    grads = {n: torch.empty(t.shape, dtype=torch.float32, device=t.device)
             for n, t in zip(WEIGHT_NAMES, weights)}
    for l in reversed(range(weights[0].shape[0])):
        w = {n: t[l] for n, t in zip(WEIGHT_NAMES, weights)}
        g = layer(xs[l], x2s[l], g, w, {n: grads[n][l] for n in WEIGHT_NAMES})
    return g, tuple(grads[n] for n in WEIGHT_NAMES)


def _write(grads: dict, out: Optional[dict]) -> dict:
    if out is None:
        return grads
    for n, t in grads.items():
        out[n].copy_(t)
    return out


def backbone_backward_plain(xs, x2s, g, weights, heads, eps, fast_gelu):
    """Plain twin of the whole backward: xs / x2s (L, B, S, D) from the
    forward's `emit_res`, g the gradient of its output. Returns (dx, fp32
    stacked weight gradients in WEIGHT_NAMES order)."""
    def layer(x, x2, dout, w, out):
        dx, grads = merged_bwd_plain(x, x2, dout, w, heads, eps, fast_gelu)
        _write(grads, out)
        return dx

    return _backbone_backward(xs, x2s, g, weights, layer)


# ---------------------------------------------------------------------------
# The CUDA kernels: checks, loading, wrappers
# ---------------------------------------------------------------------------

def _weight_shapes(layers: int, d: int, mlp: int) -> dict:
    return {
        "ln1_scale": (layers, d), "ln1_bias": (layers, d),
        "wqkv": (layers, d, 3 * d), "bqkv": (layers, 3 * d),
        "wo": (layers, d, d), "bo": (layers, d),
        "ln2_scale": (layers, d), "ln2_bias": (layers, d),
        "w1": (layers, d, mlp), "b1": (layers, mlp),
        "w2": (layers, mlp, d), "b2": (layers, d),
    }


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_activation(x: torch.Tensor, heads: Optional[int]) -> None:
    """What every kernel takes: contiguous bf16 or fp32 (B, S, D) with D a
    multiple of 64 up to KERNEL_MAX_D; the attention kernels also head_dim
    64 and S <= KERNEL_MAX_SEQ."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"backbone kernel takes bf16 or fp32 activations, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("backbone kernel takes a contiguous (B, S, D) tensor")
    b, s, d = x.shape
    if heads is not None:
        if heads <= 0 or d != heads * KERNEL_HEAD_DIM:
            raise ValueError(
                f"backbone kernel needs head_dim {KERNEL_HEAD_DIM}; got D={d}, "
                f"heads={heads}"
            )
        if s > KERNEL_MAX_SEQ:
            raise ValueError(f"backbone kernel takes S <= {KERNEL_MAX_SEQ}, got {s}")
    if d % 64 or d > KERNEL_MAX_D:
        raise ValueError(f"backbone kernel needs D a multiple of 64 and "
                         f"D <= {KERNEL_MAX_D}, got {d}")


def _check_weights(x: torch.Tensor, names, tensors, shapes: dict) -> None:
    """LN parameters fp32, matmul weights and biases in x's dtype."""
    for name, t in zip(names, tensors):
        want_dtype = torch.float32 if name.startswith("ln") else x.dtype
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want_dtype:
            raise TypeError(f"{name}: expected {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check_kernel_inputs(x: torch.Tensor, weights: Tuple, heads: int,
                         stacked: bool = True) -> None:
    """The forward kernels' operands: the backbone's stacked weights, or
    (stacked=False) one layer's."""
    _check_activation(x, heads)
    if len(weights) != len(WEIGHT_NAMES):
        raise ValueError(f"expected {len(WEIGHT_NAMES)} weight arrays")
    layers = weights[0].shape[0] if stacked else 1
    mlp = weights[8].shape[-1]
    if mlp % 64:
        raise ValueError(f"backbone kernel needs mlp a multiple of 64, got {mlp}")
    shapes = _weight_shapes(layers, x.shape[2], mlp)
    if not stacked:
        shapes = {n: s[1:] for n, s in shapes.items()}
    _check_weights(x, WEIGHT_NAMES, weights, shapes)


def _check_layer_inputs(x, other, w: dict, names, heads, out: dict) -> None:
    """One layer's backward operands: x and the incoming gradient alike,
    the layer's weights, and fp32 gradient outputs of the weights' shapes."""
    _check_activation(x, heads)
    if other.dtype != x.dtype or other.shape != x.shape or not other.is_contiguous():
        raise ValueError("the incoming gradient must be a contiguous tensor of "
                         "x's shape and dtype")
    d = x.shape[2]
    mlp = w["w1"].shape[-1] if "w1" in names else 64
    if mlp % 64:
        raise ValueError(f"backbone kernel needs mlp a multiple of 64, got {mlp}")
    shapes = {n: s[1:] for n, s in _weight_shapes(1, d, mlp).items()}
    _check_weights(x, names, [w[n] for n in names], shapes)
    for n in names:
        t = out[n]
        if (t.dtype != torch.float32 or tuple(t.shape) != shapes[n]
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"gradient output {n} must be a contiguous fp32 "
                             f"{shapes[n]} tensor on {x.device}")


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# every C entry point: (argtypes, restype)
_SIGNATURES = {
    KERNEL_NAME: {
        "vit2spn_backbone_fwd": ([_P] * 20 + [_I] * 6 + [_F, _I, _P], _I),
        "vit2spn_backbone_fwd_f32": ([_P] * 21 + [_I] * 6 + [_F, _I, _P], _I),
        "vit2spn_backbone_fwd_launches_per_layer": ([_I] * 2, _I),
        "vit2spn_backbone_fwd_qkv_pad_rows": ([], _I),
    },
    "mlp_bwd": {
        "vit2spn_mlp_bwd": ([_P] * 19 + [_I] * 3 + [_F, _I, _I, _P], _I),
        "vit2spn_mlp_bwd_workspace_floats": ([_I] * 4, _LL),
        "vit2spn_mlp_bwd_launches": ([_I] * 2, _I),
    },
    "attn_bwd": {
        "vit2spn_attn_bwd": ([_P] * 21 + [_I] * 4 + [_F, _I, _P], _I),
        "vit2spn_attn_bwd_workspace_floats": ([_I] * 5, _LL),
        "vit2spn_attn_bwd_launches": ([_I] * 2, _I),
    },
    "layer_fwd": {
        "vit2spn_layer_fwd": ([_P] * 19 + [_I] * 5 + [_F, _I, _P], _I),
        "vit2spn_layer_fwd_f32": ([_P] * 20 + [_I] * 5 + [_F, _I, _P], _I),
        "vit2spn_layer_fwd_qkv_pad_rows": ([], _I),
        "vit2spn_layer_fwd_launches": ([_I] * 2, _I),
        "vit2spn_layer_fwd_smem_bytes": ([_I] * 3, _I),
    },
    "merged_bwd": {
        "vit2spn_merged_bwd": ([_P] * 37 + [_I] * 5 + [_F, _I, _I, _P], _I),
        "vit2spn_merged_bwd_workspace_floats": ([_I] * 6, _LL),
        "vit2spn_merged_bwd_launches": ([_I], _I),
    },
    # ops/flash_attention.py's kernels
    "flash_attention": {
        "vit2spn_flash_fwd": ([_P] * 4 + [_I] * 3 + [_LL] * 2 + [_I, _P], _I),
        "vit2spn_flash_bwd": ([_P] * 8 + [_I] * 3 + [_LL] * 2 + [_I, _P], _I),
        "vit2spn_flash_bwd_workspace_floats": ([_I] * 3, _LL),
        "vit2spn_flash_fwd_launches": ([], _I),
        "vit2spn_flash_bwd_launches": ([], _I),
    },
}
KERNEL_NAMES = tuple(_SIGNATURES)


def _load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built on first use, its entry points
    typed."""
    from vit2spn_tpu_torch.ops import cuda_build

    lib = cuda_build.load(name)
    if not getattr(lib, "_vit2spn_typed", False):
        for fn, (args, res) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        lib.vit2spn_cuda_error_string.argtypes = [_I]
        lib.vit2spn_cuda_error_string.restype = ctypes.c_char_p
        lib._vit2spn_typed = True
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.vit2spn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def kernel_launches_per_layer(d: int, fp32: bool = False) -> int:
    """CUDA kernel launches one backbone forward layer of width `d` costs,
    bf16 or fp32 (builds if needed)."""
    return _load(KERNEL_NAME).vit2spn_backbone_fwd_launches_per_layer(d, int(fp32))


def cuda_launches(name: str, lib: Optional[str] = None, *args: int) -> int:
    """CUDA kernel launches one call of the `name` wrapper costs (one layer
    of `layer_fwd`, `mlp_bwd`, `attn_bwd`, which take the width D and 1 for
    fp32 in `args`, `merged_bwd`, which takes the fp32 flag; one attention
    of `flash_fwd`, `flash_bwd`), from the library of csrc/<lib or name>.cu
    (builds if needed)."""
    return getattr(_load(lib or name), f"vit2spn_{name}_launches")(*args)


def layer_fwd_smem_bytes(s: int, d: int, kernel: str) -> int:
    """Dynamic shared memory per block of one of the forward layer's kernels
    ("ln_qkv", "attention", "mlp") at sequence length s and width d (builds
    if needed)."""
    which = ("ln_qkv", "attention", "mlp").index(kernel)
    return _load("layer_fwd").vit2spn_layer_fwd_smem_bytes(s, d, which)


def _layer_scratch(m: int, d: int, mlp: int, pad: int, dev) -> tuple:
    """The bf16 forward layer's scratch: qkv (with `pad` rows the kernel
    zeroes: attention reads 16-row steps), att, and above FUSED_MLP_MAX_D
    the fp32 x2 and g that the layer then passes through device memory
    (else None)."""
    qkv = torch.empty((m + pad, 3 * d), dtype=torch.bfloat16, device=dev)
    att = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    if d <= FUSED_MLP_MAX_D:
        return qkv, att, None, None
    return (qkv, att, torch.empty((m, d), dtype=torch.float32, device=dev),
            torch.empty((m, mlp), dtype=torch.bfloat16, device=dev))


def _layer_scratch_f32(m: int, d: int, mlp: int, dev) -> tuple:
    """The fp32 forward layer's scratch: y (y1, then y2), qkv, att, x2, g."""
    def f(n):
        return torch.empty((m, n), dtype=torch.float32, device=dev)

    return f(d), f(3 * d), f(d), f(d), f(mlp)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _backbone_fwd_cuda(x, weights, heads, eps, fast_gelu, emit_res):
    _check_kernel_inputs(x, weights, heads)
    lib = _load(KERNEL_NAME)
    b, s, d = x.shape
    layers, mlp = weights[0].shape[0], weights[8].shape[-1]
    m = b * s
    dev = x.device
    out = torch.empty_like(x)
    xs = x2s = None
    if emit_res:
        xs = torch.empty((layers, b, s, d), dtype=x.dtype, device=dev)
        x2s = torch.empty((layers, b, s, d), dtype=x.dtype, device=dev)
    if x.dtype == torch.float32:
        fn, scratch = lib.vit2spn_backbone_fwd_f32, _layer_scratch_f32(m, d, mlp, dev)
    else:
        fn = lib.vit2spn_backbone_fwd
        scratch = _layer_scratch(m, d, mlp, lib.vit2spn_backbone_fwd_qkv_pad_rows(), dev)
    with torch.cuda.device(dev), torch.profiler.record_function(f"vit2spn::{KERNEL_NAME}"):
        rc = fn(
            x.data_ptr(), out.data_ptr(), _ptr(xs), _ptr(x2s),
            *[t.data_ptr() for t in weights], *[_ptr(t) for t in scratch],
            b, s, d, heads, mlp, layers, float(eps), int(bool(fast_gelu)),
            _stream(dev),
        )
    _raise_on(lib, rc, "backbone")
    fused_backbone.launches += 1
    if emit_res:
        return out, xs, x2s
    return out


def _dy_scratch(x: torch.Tensor, m: int, d: int) -> Optional[torch.Tensor]:
    """The fp32 dy a backward half passes through device memory: only off
    the wgmma route (fp32, or D above HOPPER_BWD_MAX_D), else None."""
    if x.dtype == torch.bfloat16 and d <= HOPPER_BWD_MAX_D:
        return None
    return torch.empty((m, d), dtype=torch.float32, device=x.device)


def _grad_outputs(w: dict, names, out: Optional[dict]) -> dict:
    if out is not None:
        return out
    return {n: torch.empty(w[n].shape, dtype=torch.float32, device=w[n].device)
            for n in names}


def mlp_bwd(x2: torch.Tensor, dout: torch.Tensor, w: dict, eps: float,
            fast_gelu: bool, out: Optional[dict] = None):
    """One layer's MLP backward: (dx2, {name: fp32 gradient} over MLP_NAMES).

    CUDA tensors go through csrc/mlp_bwd.cu (bf16 or fp32; anything it does
    not take raises), CPU tensors through `mlp_bwd_plain`. The gradients are
    written into `out` when it is given."""
    if x2.device.type == "cpu":
        dx2, grads = mlp_bwd_plain(x2, dout, w, eps, fast_gelu)
        return dx2, _write(grads, out)
    if x2.device.type != "cuda":
        raise ValueError(f"mlp_bwd runs on cuda or cpu, not {x2.device}")
    out = _grad_outputs(w, MLP_NAMES, out)
    _check_layer_inputs(x2, dout, w, MLP_NAMES, None, out)
    lib = _load("mlp_bwd")
    b, s, d = x2.shape
    m, mlp = b * s, w["w1"].shape[1]
    dev = x2.device
    fp32 = int(x2.dtype == torch.float32)
    dx2 = torch.empty_like(x2)
    y2 = torch.empty((m, d), dtype=x2.dtype, device=dev)
    g = torch.empty((m, mlp), dtype=x2.dtype, device=dev)
    gg = torch.empty((m, mlp), dtype=x2.dtype, device=dev)
    dy = _dy_scratch(x2, m, d)
    ws = torch.empty(lib.vit2spn_mlp_bwd_workspace_floats(m, d, mlp, fp32),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), torch.profiler.record_function("vit2spn::mlp_bwd"):
        rc = lib.vit2spn_mlp_bwd(
            x2.data_ptr(), dout.data_ptr(), *[w[n].data_ptr() for n in MLP_NAMES[:5]],
            dx2.data_ptr(), *[out[n].data_ptr() for n in MLP_NAMES],
            y2.data_ptr(), g.data_ptr(), gg.data_ptr(), _ptr(dy), ws.data_ptr(),
            m, d, mlp, float(eps), int(bool(fast_gelu)), fp32, _stream(dev),
        )
    _raise_on(lib, rc, "mlp backward")
    mlp_bwd.launches += 1
    return dx2, out


def attn_bwd(x: torch.Tensor, dx2: torch.Tensor, w: dict, heads: int, eps: float,
             out: Optional[dict] = None):
    """One layer's attention backward: (dx, {name: fp32 gradient} over
    ATTN_NAMES).

    CUDA tensors go through csrc/attn_bwd.cu (bf16 or fp32; anything it
    does not take raises), CPU tensors through `attn_bwd_plain`. The
    gradients are written into `out` when it is given."""
    if x.device.type == "cpu":
        dx, grads = attn_bwd_plain(x, dx2, w, heads, eps)
        return dx, _write(grads, out)
    if x.device.type != "cuda":
        raise ValueError(f"attn_bwd runs on cuda or cpu, not {x.device}")
    out = _grad_outputs(w, ATTN_NAMES, out)
    _check_layer_inputs(x, dx2, w, ATTN_NAMES, heads, out)
    lib = _load("attn_bwd")
    b, s, d = x.shape
    m = b * s
    dev = x.device

    fp32 = int(x.dtype == torch.float32)

    def act(n):
        return torch.empty((m, n), dtype=x.dtype, device=dev)

    dx = torch.empty_like(x)
    y1, qkv, datt, att, dqkv = act(d), act(3 * d), act(d), act(d), act(3 * d)
    dy = _dy_scratch(x, m, d)
    ws = torch.empty(lib.vit2spn_attn_bwd_workspace_floats(b, s, d, heads, fp32),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), torch.profiler.record_function("vit2spn::attn_bwd"):
        rc = lib.vit2spn_attn_bwd(
            x.data_ptr(), dx2.data_ptr(), *[w[n].data_ptr() for n in ATTN_NAMES[:5]],
            dx.data_ptr(), *[out[n].data_ptr() for n in ATTN_NAMES],
            y1.data_ptr(), qkv.data_ptr(), datt.data_ptr(), att.data_ptr(),
            dqkv.data_ptr(), _ptr(dy), ws.data_ptr(),
            b, s, d, heads, float(eps), fp32, _stream(dev),
        )
    _raise_on(lib, rc, "attention backward")
    attn_bwd.launches += 1
    return dx, out


def merged_bwd(x: torch.Tensor, x2: torch.Tensor, dout: torch.Tensor, w: dict, heads: int,
               eps: float, fast_gelu: bool, out: Optional[dict] = None):
    """One layer's whole backward, MLP half then attention half: (dx, {name:
    fp32 gradient} over WEIGHT_NAMES).

    CUDA tensors go through csrc/merged_bwd.cu (bf16 or fp32; anything it
    does not take raises), CPU tensors through `merged_bwd_plain`. The
    gradients are written into `out` when it is given."""
    if x.device.type == "cpu":
        dx, grads = merged_bwd_plain(x, x2, dout, w, heads, eps, fast_gelu)
        return dx, _write(grads, out)
    if x.device.type != "cuda":
        raise ValueError(f"merged_bwd runs on cuda or cpu, not {x.device}")
    out = _grad_outputs(w, WEIGHT_NAMES, out)
    _check_layer_inputs(x2, dout, w, MLP_NAMES, None, out)
    _check_layer_inputs(x, dout, w, ATTN_NAMES, heads, out)
    lib = _load("merged_bwd")
    b, s, d = x.shape
    m, mlp = b * s, w["w1"].shape[1]
    dev = x.device

    fp32 = int(x.dtype == torch.float32)

    def act(n):
        return torch.empty((m, n), dtype=x.dtype, device=dev)

    dx = torch.empty_like(x)
    y1, y2, qkv, datt, att, dqkv = act(d), act(d), act(3 * d), act(d), act(d), act(3 * d)
    g, gg, dx2 = act(mlp), act(mlp), act(d)
    dy = torch.empty((m, d), dtype=torch.float32, device=dev)
    ws = torch.empty(lib.vit2spn_merged_bwd_workspace_floats(b, s, d, heads, mlp, fp32),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), torch.profiler.record_function("vit2spn::merged_bwd"):
        rc = lib.vit2spn_merged_bwd(
            x.data_ptr(), x2.data_ptr(), dout.data_ptr(),
            *[w[n].data_ptr() for n in ATTN_NAMES[:5] + MLP_NAMES[:5]],
            dx.data_ptr(), *[out[n].data_ptr() for n in WEIGHT_NAMES],
            *[t.data_ptr() for t in (y1, y2, qkv, datt, att, dqkv, g, gg, dx2, dy, ws)],
            b, s, d, heads, mlp, float(eps), int(bool(fast_gelu)), fp32, _stream(dev),
        )
    _raise_on(lib, rc, "merged backward")
    merged_bwd.launches += 1
    return dx, out


def merged_bwd_enabled() -> bool:
    """VIT2SPN_MERGED_BWD=1: the backbone backward runs `merged_bwd` per
    layer instead of the two halves. Read at each backward call, as the JAX
    package reads it when it traces its backward."""
    return os.environ.get("VIT2SPN_MERGED_BWD", "0") == "1"


def _layer_backward(merged: bool, heads: int, eps: float, fast_gelu: bool):
    """One layer's backward for `_backbone_backward`: the merged kernel, or
    the MLP half then the attention half."""
    if merged:
        return lambda x, x2, dout, w, out: merged_bwd(x, x2, dout, w, heads, eps,
                                                      fast_gelu, out)[0]

    def split(x, x2, dout, w, out):
        dx2 = mlp_bwd(x2, dout, w, eps, fast_gelu, out)[0]
        return attn_bwd(x, dx2, w, heads, eps, out)[0]

    return split


def _backbone_forward(x, weights, heads, eps, fast_gelu, emit_res):
    if x.device.type == "cuda":
        return _backbone_fwd_cuda(x, weights, heads, eps, fast_gelu, emit_res)
    if x.device.type != "cpu":
        raise ValueError(f"fused_backbone runs on cuda or cpu, not {x.device}")
    return backbone_forward_plain(x, weights, heads, eps, fast_gelu, emit_res)


class _FusedBackbone(torch.autograd.Function):
    """`fused_backbone` under autograd, as the JAX package's custom_vjp: the
    forward keeps the xs / x2s residual stacks, the backward runs each
    layer's backward in reverse (the kernels on CUDA, their plain twins on
    the CPU): the MLP half then the attention half, or the merged kernel
    under VIT2SPN_MERGED_BWD=1. Weight gradients come back in each weight's
    own dtype, as `_backbone_vjp_bwd` casts them."""

    @staticmethod
    def forward(ctx, x, heads, eps, fast_gelu, *weights):
        out, xs, x2s = _backbone_forward(x, weights, heads, eps, fast_gelu, True)
        ctx.save_for_backward(xs, x2s, *weights)
        ctx.args = (heads, eps, fast_gelu)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, x2s, *weights = ctx.saved_tensors
        layer = _layer_backward(merged_bwd_enabled(), *ctx.args)
        dx, dws = _backbone_backward(xs, x2s, g, weights, layer)
        return (dx, None, None, None,
                *(dw.to(w.dtype) for dw, w in zip(dws, weights)))


def fused_backbone(x: torch.Tensor, weights: Tuple, heads: int, eps: float,
                   fast_gelu: Optional[bool] = None, emit_res: bool = False):
    """Run the full transformer stack over x: (B, S, D).

    CUDA tensors go through the hand-written kernels (bf16 or fp32;
    anything they do not take raises); CPU tensors through the plain twins.
    `fast_gelu=None` resolves from VIT2SPN_FAST_GELU. Returns out, or
    (out, xs, x2s) with `emit_res` (the training forward's residuals).
    When autograd needs a gradient of x or a weight, the call goes through
    `_FusedBackbone`; without one (`no_grad`, the target nets, serving) no
    residual is kept."""
    if fast_gelu is None:
        fast_gelu = fast_gelu_default()
    if (not emit_res and torch.is_grad_enabled()
            and (x.requires_grad or any(t.requires_grad for t in weights))):
        return _FusedBackbone.apply(x, heads, eps, fast_gelu, *weights)
    return _backbone_forward(x, weights, heads, eps, fast_gelu, emit_res)


# ---------------------------------------------------------------------------
# One layer: the "fused_layer" path (`fused_block`, `_fwd_kernel`)
# ---------------------------------------------------------------------------

def layer_fwd(x: torch.Tensor, weights: Tuple, heads: int, eps: float, fast_gelu: bool,
              emit_x2: bool = True):
    """One block over x (B, S, D): (out, x2) with `emit_x2`, else out, both
    in x.dtype. `weights`: one layer's tuple in WEIGHT_NAMES order.

    CUDA tensors go through csrc/layer_fwd.cu (bf16 or fp32; anything it
    does not take raises), CPU tensors through `layer_forward_plain`."""
    if x.device.type == "cpu":
        out, x2 = layer_forward_plain(x, weights, heads, eps, fast_gelu)
        return (out, x2) if emit_x2 else out
    if x.device.type != "cuda":
        raise ValueError(f"layer_fwd runs on cuda or cpu, not {x.device}")
    _check_kernel_inputs(x, weights, heads, stacked=False)
    lib = _load("layer_fwd")
    b, s, d = x.shape
    m, mlp = b * s, weights[8].shape[-1]
    dev = x.device
    out = torch.empty_like(x)
    x2 = torch.empty_like(x) if emit_x2 else None
    if x.dtype == torch.float32:
        fn, scratch = lib.vit2spn_layer_fwd_f32, _layer_scratch_f32(m, d, mlp, dev)
    else:
        fn = lib.vit2spn_layer_fwd
        scratch = _layer_scratch(m, d, mlp, lib.vit2spn_layer_fwd_qkv_pad_rows(), dev)
    with torch.cuda.device(dev), torch.profiler.record_function("vit2spn::layer_fwd"):
        rc = fn(
            x.data_ptr(), out.data_ptr(), _ptr(x2),
            *[t.data_ptr() for t in weights], *[_ptr(t) for t in scratch],
            b, s, d, heads, mlp, float(eps), int(bool(fast_gelu)), _stream(dev),
        )
    _raise_on(lib, rc, "layer forward")
    layer_fwd.launches += 1
    return (out, x2) if emit_x2 else out


class _FusedBlock(torch.autograd.Function):
    """`fused_block` under autograd, as the JAX package's custom_vjp: the
    forward keeps x and the mid-residual x2, the backward runs the MLP half
    then the attention half (`_fused_bwd`, which never merges them)."""

    @staticmethod
    def forward(ctx, x, heads, eps, fast_gelu, *weights):
        out, x2 = layer_fwd(x, weights, heads, eps, fast_gelu)
        ctx.save_for_backward(x, x2, *weights)
        ctx.args = (heads, eps, fast_gelu)
        return out

    @staticmethod
    def backward(ctx, g):
        x, x2, *weights = ctx.saved_tensors
        w = dict(zip(WEIGHT_NAMES, weights))
        grads = _grad_outputs(w, WEIGHT_NAMES, None)
        dx = _layer_backward(False, *ctx.args)(x, x2, g.to(x.dtype).contiguous(), w, grads)
        return (dx, None, None, None,
                *(grads[n].to(t.dtype) for n, t in zip(WEIGHT_NAMES, weights)))


def fused_block(x: torch.Tensor, weights: Tuple, heads: int, eps: float,
                fast_gelu: Optional[bool] = None) -> torch.Tensor:
    """One pre-LN block over x (B, S, D), `weights` one layer's tuple in
    WEIGHT_NAMES order (LN params fp32, matmul weights and biases in x's
    dtype): the port of the JAX `fused_block`. CUDA tensors go through
    csrc/layer_fwd.cu and, under autograd, the split backward kernels; CPU
    tensors through the plain twins. `fast_gelu=None` resolves from
    VIT2SPN_FAST_GELU."""
    if fast_gelu is None:
        fast_gelu = fast_gelu_default()
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in weights)):
        return _FusedBlock.apply(x, heads, eps, fast_gelu, *weights)
    return layer_fwd(x, weights, heads, eps, fast_gelu, emit_x2=False)


# kernel launches through the wrappers (one per backbone forward, one per
# layer forward, one per layer of each backward); the plain twins never count
fused_backbone.launches = 0
layer_fwd.launches = 0
mlp_bwd.launches = 0
attn_bwd.launches = 0
merged_bwd.launches = 0
