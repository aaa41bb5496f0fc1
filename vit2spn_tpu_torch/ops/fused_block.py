"""Whole-backbone ViT forward: the Hopper kernel, its plain twin, its wrapper.

Port of `vit2spn_tpu/ops/fused_block.py::fused_backbone` (the Pallas kernel
`_backbone_fwd_kernel`). Three pieces:

  * `backbone_forward_plain` — plain PyTorch, layer after layer, with the
    Pallas kernel's rounding points (`_block_fwd_math`): bf16 LN outputs
    before their GEMMs, bf16 qkv, bf16 softmax probabilities before P.V,
    fp32 x2 inside the layer, a bf16 residual stream between layers, fp32
    gelu then bf16. Matmuls take compute-dtype inputs and accumulate in fp32.
  * the CUDA kernel in `csrc/backbone_fwd.cu` (seven launches per layer on
    the current stream), built on first use (ops/cuda_build.py).
  * `fused_backbone` — the wrapper. For CPU tensors it runs the plain twin;
    for CUDA tensors it launches the kernel, or raises on what the kernel
    does not take. It never falls back from CUDA to the plain twin.

Layout: x (B, S, D); weights a tuple of STACKED arrays in WEIGHT_NAMES order
with a leading layer axis — LN params fp32 (L, D), matmul weights (L, in,
out) and biases (L, n) in compute dtype. Unlike the TPU kernel nothing is
padded to a multiple of 16 tokens in memory: the kernel masks its own pad
keys, so the xs / x2s residual stacks are (L, B, S, D).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from vit2spn_tpu_torch.ops.attention import mha_plain

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


def _ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """fp32 layernorm: mean, then the mean of squared deviations."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    xhat = (x32 - mean) * torch.rsqrt(var + eps)
    return xhat * scale.float() + bias.float()


def _block_fwd_plain(x: torch.Tensor, w: dict, heads: int, eps: float,
                     fast_gelu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN block with `_block_fwd_math`'s rounding points. Returns
    (out fp32, x2 fp32); x is in compute dtype."""
    dtype = x.dtype
    b, s, d = x.shape
    dh = d // heads
    y1 = _ln_fwd(x, w["ln1_scale"], w["ln1_bias"], eps).to(dtype)
    qkv = (y1.float() @ w["wqkv"].float() + w["bqkv"].float()).to(dtype)
    q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(d, dim=-1))
    att = mha_plain(q, k, v).reshape(b, s, d)
    o = att.float() @ w["wo"].float()
    x2 = x.float() + o + w["bo"].float()
    y2 = _ln_fwd(x2, w["ln2_scale"], w["ln2_bias"], eps).to(dtype)
    m1 = y2.float() @ w["w1"].float() + w["b1"].float()
    g = gelu(m1, fast_gelu).to(dtype)
    m2 = g.float() @ w["w2"].float()
    out = x2 + m2 + w["b2"].float()
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


def _weight_shapes(layers: int, d: int, mlp: int) -> dict:
    return {
        "ln1_scale": (layers, d), "ln1_bias": (layers, d),
        "wqkv": (layers, d, 3 * d), "bqkv": (layers, 3 * d),
        "wo": (layers, d, d), "bo": (layers, d),
        "ln2_scale": (layers, d), "ln2_bias": (layers, d),
        "w1": (layers, d, mlp), "b1": (layers, mlp),
        "w2": (layers, mlp, d), "b2": (layers, d),
    }


def _check_kernel_inputs(x: torch.Tensor, weights: Tuple, heads: int) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"backbone kernel takes bf16 activations, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("backbone kernel takes a contiguous (B, S, D) tensor")
    if len(weights) != len(WEIGHT_NAMES):
        raise ValueError(f"expected {len(WEIGHT_NAMES)} weight arrays")
    b, s, d = x.shape
    if heads <= 0 or d != heads * KERNEL_HEAD_DIM:
        raise ValueError(
            f"backbone kernel needs head_dim {KERNEL_HEAD_DIM}; got D={d}, "
            f"heads={heads}"
        )
    layers, mlp = weights[0].shape[0], weights[8].shape[-1]
    if d % 64 or mlp % 64 or d > KERNEL_MAX_D:
        raise ValueError(f"backbone kernel needs D and mlp multiples of 64 "
                         f"and D <= {KERNEL_MAX_D}, got {d}, {mlp}")
    if s > KERNEL_MAX_SEQ:
        raise ValueError(f"backbone kernel takes S <= {KERNEL_MAX_SEQ}, got {s}")
    shapes = _weight_shapes(layers, d, mlp)
    for name, t in zip(WEIGHT_NAMES, weights):
        want_dtype = torch.float32 if name.startswith("ln") else torch.bfloat16
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want_dtype:
            raise TypeError(f"{name}: expected {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _load_kernel() -> ctypes.CDLL:
    from vit2spn_tpu_torch.ops import cuda_build

    lib = cuda_build.load(KERNEL_NAME)
    if not getattr(lib, "_vit2spn_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vit2spn_backbone_fwd.argtypes = (
            [p] * 20 + [i] * 6 + [ctypes.c_float, i, p]
        )
        lib.vit2spn_backbone_fwd.restype = i
        for fn in ("vit2spn_backbone_fwd_launches_per_layer",
                   "vit2spn_backbone_fwd_qkv_pad_rows"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.vit2spn_cuda_error_string.argtypes = [i]
        lib.vit2spn_cuda_error_string.restype = ctypes.c_char_p
        lib._vit2spn_typed = True
    return lib


def kernel_launches_per_layer() -> int:
    """CUDA kernel launches one backbone layer costs (builds if needed)."""
    return _load_kernel().vit2spn_backbone_fwd_launches_per_layer()


def _backbone_fwd_cuda(x, weights, heads, eps, fast_gelu, emit_res):
    _check_kernel_inputs(x, weights, heads)
    lib = _load_kernel()
    b, s, d = x.shape
    layers, mlp = weights[0].shape[0], weights[8].shape[-1]
    m = b * s
    dev = x.device
    out = torch.empty_like(x)
    xs = x2s = None
    if emit_res:
        xs = torch.empty((layers, b, s, d), dtype=x.dtype, device=dev)
        x2s = torch.empty((layers, b, s, d), dtype=x.dtype, device=dev)
    # attention reads 16-row steps: the kernel zeroes these pad rows
    pad = lib.vit2spn_backbone_fwd_qkv_pad_rows()
    qkv = torch.empty((m + pad, 3 * d), dtype=torch.bfloat16, device=dev)
    att = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    x2 = torch.empty((m, d), dtype=torch.float32, device=dev)
    g = torch.empty((m, mlp), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vit2spn_backbone_fwd(
            x.data_ptr(), out.data_ptr(),
            xs.data_ptr() if emit_res else None,
            x2s.data_ptr() if emit_res else None,
            *[t.data_ptr() for t in weights],
            qkv.data_ptr(), att.data_ptr(), x2.data_ptr(), g.data_ptr(),
            b, s, d, heads, mlp, layers, float(eps), int(bool(fast_gelu)),
            stream,
        )
    if rc != 0:
        msg = lib.vit2spn_cuda_error_string(rc).decode()
        raise RuntimeError(f"backbone kernel launch failed: {msg} ({rc})")
    fused_backbone.launches += 1
    if emit_res:
        return out, xs, x2s
    return out


def fused_backbone(x: torch.Tensor, weights: Tuple, heads: int, eps: float,
                   fast_gelu: Optional[bool] = None, emit_res: bool = False):
    """Run the full transformer stack over x: (B, S, D).

    CUDA tensors go through the hand-written kernel (bf16 only; anything it
    does not take raises); CPU tensors through `backbone_forward_plain`.
    `fast_gelu=None` resolves from VIT2SPN_FAST_GELU. Returns out, or
    (out, xs, x2s) with `emit_res` (the training forward's residuals)."""
    if fast_gelu is None:
        fast_gelu = fast_gelu_default()
    if x.device.type == "cuda":
        return _backbone_fwd_cuda(x, weights, heads, eps, fast_gelu, emit_res)
    if x.device.type != "cpu":
        raise ValueError(f"fused_backbone runs on cuda or cpu, not {x.device}")
    return backbone_forward_plain(x, weights, heads, eps, fast_gelu, emit_res)


# kernel launches through the wrapper (one per backbone forward); the plain
# twin never counts
fused_backbone.launches = 0
