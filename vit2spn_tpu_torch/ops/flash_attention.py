"""Attention with every value in fp32 inside: the kernels, their plain twins,
their wrappers and the autograd Function (port of
`vit2spn_tpu/ops/flash_attention.py`, the attention of the per-op block
under attn_impl="pallas").

The Pallas kernels `_fwd_kernel` and `_bwd_kernel` cast q, k, v (and dO)
to fp32 and keep every intermediate fp32: the probabilities P are not
rounded before P.V or P^T dO, nor dS before dS K and dS^T Q. Only the
outputs are cast to q's dtype. That differs from `mha_plain`
(ops/attention.py, the JAX `mha_xla`), which rounds P to the value dtype,
and from the fused block's attention. Per kernel three pieces:

  * the plain twins `flash_attention_plain` (forward) and
    `flash_attention_bwd_plain` (dq, dk, dv), plain fp32 PyTorch;
  * the CUDA kernels in csrc/flash_attention.cu (one forward launch, two
    backward launches), built on first use (ops/cuda_build.py): for bf16
    inputs on the tensor cores, P and dS entering their products as two
    bf16 terms (hi + lo, the fp32 value to about 2^-17); for fp32 inputs on
    the CUDA cores;
  * the wrappers `flash_fwd` and `flash_bwd`: the plain twin for CPU
    tensors, the kernel for CUDA tensors (bf16 or fp32; anything else
    raises), counting launches in `.launches` under the profiler range
    `vit2spn::flash_fwd` / `vit2spn::flash_bwd`.

`mha_pallas(q, k, v)` takes and returns the JAX layout (B, S, H, Dh) and
runs through `_Flash` under autograd. The kernels read q, k, v in place
through their strides (the views the split of a (B, S, 3D) qkv gives); dO
is made contiguous, and o, dq, dk, dv are contiguous (B, S, H, Dh). The
sequence is not padded in memory: keys >= S get probability exactly 0 and
queries >= S are never written, as the Pallas kernels' -1e30 key mask and
zeroed pad query rows leave them.
"""

from __future__ import annotations

import math

import torch

from vit2spn_tpu_torch.ops.fused_block import (
    _load,
    _raise_on,
    _stream,
    check_geometry,
    count_long_seq,
)

# the Pallas kernels' key mask
NEG_INF = -1e30
KERNEL_NAME = "flash_attention"
# what csrc/flash_attention.cu takes (fused_block.geometry_route without an
# MLP or a LayerNorm, so any D): head_dim 16, 32, 48, 64 or 80 at any S
# (above fused_block.KERNEL_MAX_SEQ the multi-pass routes:
# csrc/long_attention.cuh at head_dim 64 and csrc/general_long.cuh at 16-48
# in bf16, csrc/flash_f32.cuh in fp32; at head_dim 80 those at every S)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 softmax(q k^T / sqrt(dh)) over (B, S, H, Dh): (B, H, Sq, Sk), as
    the Pallas kernels compute it (max, exp, then the division)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return p / torch.sum(p, dim=-1, keepdim=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain twin of the forward kernel: softmax(q k^T / sqrt(dh)) v over (B,
    S, H, Dh), all fp32, the output in q.dtype."""
    o = torch.einsum("bhqk,bkhd->bqhd", _probs(q, k), v.float())
    return o.to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor):
    """Plain twin of the backward kernel (`_bwd_kernel`): P recomputed, dV =
    P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)), dQ = dS K / sqrt(dh),
    dK = dS^T Q / sqrt(dh), all fp32. Returns (dq, dk, dv) in q.dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take: q, k, v of one shape (B, S, H, Dh) of a
    geometry `check_geometry` accepts without a LayerNorm (head_dim 16, 32,
    48, 64 or 80 at any S and any number of heads), one dtype
    (bf16 or fp32), one device and one set of strides, each head's Dh values
    contiguous and the heads of a token side by side."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash attention kernel takes bf16 or fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
        if t.stride() != q.stride():
            raise ValueError(f"{name} must have q's strides")
    if q.dim() != 4:
        raise ValueError("flash attention kernel takes (B, S, H, Dh) tensors")
    b, s, h, dh = q.shape
    check_geometry(h * dh, h, None, s, "flash attention", layernorm=False)
    bs, ts, hs, ds = q.stride()
    if ds != 1 or (h > 1 and hs != dh) or ts < h * dh or (b > 1 and bs < s * ts):
        raise ValueError("flash attention kernel needs each token's heads side by side "
                         f"(strides (*, >= {h * dh}, {dh}, 1)), got {q.stride()}")
    # each row starts on 16 bytes for the bf16 kernels' cp.async, on 8 for fp32
    align = 2 if q.dtype == torch.float32 else 8
    if ts % align or (b > 1 and bs % align) or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs 16-byte aligned tensors with rows "
                         f"{q.element_size() * align}-byte aligned")


def _flash_args(q: torch.Tensor):
    b, s, h, dh = q.shape
    bs, ts = q.stride()[:2]
    return b, s, h, dh, max(bs, s * ts), ts, int(q.dtype == torch.float32)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention forward over (B, S, H, Dh): o (B, S, H, Dh) in q.dtype.
    CUDA tensors go through csrc/flash_attention.cu, CPU tensors through
    `flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    _check_flash_inputs(q, k, v)
    lib = _load(KERNEL_NAME)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device), torch.profiler.record_function("vit2spn::flash_fwd"):
        rc = lib.vit2spn_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   *_flash_args(q), _stream(q.device))
    _raise_on(lib, rc, "flash attention forward")
    flash_fwd.launches += 1
    count_long_seq("flash_fwd", q.shape[1])
    return o


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor):
    """Attention backward: (dq, dk, dv), each (B, S, H, Dh) in q.dtype. CUDA
    tensors go through csrc/flash_attention.cu, CPU tensors through
    `flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu, not {q.device}")
    _check_flash_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("the output gradient must match q's shape, dtype and device")
    do = do.contiguous()
    lib = _load(KERNEL_NAME)
    b, s, h, _ = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty(lib.vit2spn_flash_bwd_workspace_floats(b, s, h),
                        dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device), torch.profiler.record_function("vit2spn::flash_bwd"):
        rc = lib.vit2spn_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), *_flash_args(q),
            _stream(q.device))
    _raise_on(lib, rc, "flash attention backward")
    flash_bwd.launches += 1
    count_long_seq("flash_bwd", s)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """`mha_pallas`'s custom_vjp (`_flash`): the forward keeps q, k, v, the
    backward recomputes P (the kernels on CUDA, the twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return flash_bwd(q, k, v, g.to(q.dtype))


def mha_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, S, H, Dh); returns (B, S, H, Dh) in v.dtype, with
    P and dS in fp32 (the JAX `mha_pallas`)."""
    return _Flash.apply(q, k, v).to(v.dtype)


# kernel launches through the wrappers (the backward's two CUDA launches
# count once); the plain twins never count
flash_fwd.launches = 0
flash_bwd.launches = 0
