#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit2spn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from csrc/ (one nvcc per source, all started
     together), with seconds and the compiler's register / shared-memory
     report;
  3. the backbone-forward kernel against its plain PyTorch twin on the card,
     at the shapes the serving path gives it (ViT-Tiny: L=12, D=192, 3 heads,
     mlp 768, S=197, B=256, bf16), both gelu forms and both emit_res
     settings, and at a few other shapes it takes (ragged batches, short and
     256-token sequences, the ViT-Small and ViT-Base widths);
  4. the two backward kernels (one layer's MLP half and attention half)
     against their plain twins at the training shape (ViT-Tiny, B=128), both
     gelu forms, dx and every weight gradient, and as close to an fp32
     backward as the twins are; at ragged B, S = 5, 17 and 256 and the
     ViT-Small width; the forward kernel at the training shape (B=128,
     emit_res) against its twin, as in phase 3; the 12-layer backward
     through the autograd Function against `backbone_backward_plain` on that
     forward's residuals; two backward runs giving the same weight-gradient
     bits;
  5. the serving path end to end: SSPTrainer on the dual-stream `ssp` preset
     (random init from the seed) runs extract_features over 1024 synthetic
     28 px images at batch 256. The launch counters are set to 0 just before
     and read just after; the features must be finite, (1024, 128), and
     agree with the same path run through the plain twin;
  6. the training path end to end: `fit` of the `ssp` preset (full width and
     depth, 8 microbatches of 128, bf16) over 4096 synthetic 28 px images,
     four optimizer steps, with the counters set to 0 just before and read
     just after: finite losses, 32 forward launches and 192 launches of each
     backward kernel per step; and step 1 against the same step run with
     attn_impl="plain" from the same state (loss, Adam's first moments, the
     updated params);
  7. times with CUDA events after a warm-up: each kernel, its plain twin, a
     library yardstick (F.layer_norm / torch.matmul / SDPA / F.gelu, and
     their torch autograd for the backward halves) and the least time the
     card could take for the same work; extract images/s; the optimizer
     step's images/s, and from torch.profiler its device time by kernel
     wrapper (each wrapper's `vit2spn::<name>` range) and by CUDA kernel.

The line before the last is one JSON object {"kernels": [...]} with each
kernel's numbers; the last line is {"ok": true, "device": {...}}. The
script needs no network and no JAX, and stops every process it starts.
"""

from __future__ import annotations

import bisect
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SEED = 0
BATCH = 256
N_IMAGES = 1024
# Kernel vs plain twin, bf16 at 12 layers: both round every layer's output
# to bf16 (8 significant bits) but sum their fp32 products in different
# orders, so a value near a rounding boundary can land one bf16 step apart,
# and the residual stream carries that step through the later layers. At one
# layer 99.8% of the outputs are identical (ViT-Tiny shapes, H100); at 12
# layers about a third differ, by 1.3e-3 on average.
#   * the largest difference may be 4 bf16 steps at the output's largest
#     magnitude (|x| < 8: 4 * 2**-5);
#   * the mean difference may be 3e-3 (0.4 of a step at magnitude 1);
#   * the kernel must be as close to an fp32 forward of the same weights
#     and input as the plain twin is: mean error at most 5% above the twin's.
KERNEL_MAX_ABS_TOL = 0.125
KERNEL_MEAN_ABS_TOL = 3e-3
KERNEL_VS_FP32_RATIO = 1.05
# Served features (prediction-head output) through the kernel vs through the
# plain twin: relative to the features' largest magnitude.
FEATURE_REL_TOL = 2e-2
# Backward kernels vs their plain twins, one layer at B=128 (bf16): both
# round at the same points (bf16 m1, dm1, datt, dS, dqkv and outputs) but sum
# in other orders, so a value near a bf16 boundary lands one step apart. At
# the training shape the largest difference is 0.4% of the output's largest
# magnitude. Tolerances, relative to the twin's largest magnitude per output:
BWD_MAX_REL_TOL = 2e-2
BWD_MEAN_REL_TOL = 2e-3
# ... and against an fp32 backward of the same inputs the kernel's mean error
# (relative to the output's largest magnitude) may be at most 5% above the
# twin's, plus 1e-6 for outputs that both get to fp32 roundoff (bias sums of
# bf16 values).
BWD_VS_FP32_SLACK = 1e-6
# The 12-layer backward (the Function on the card vs backbone_backward_plain):
# dx crosses 12 layers in bf16, so the one-step differences compound.
BWD12_MAX_REL_TOL = 5e-2
BWD12_MEAN_REL_TOL = 5e-3
# Step 1 of training, kernels vs attn_impl="plain" (torch autograd through the
# plain bf16 forward, which rounds its gradients elsewhere): the loss within
# 1e-3 relative; Adam's first moments (0.1 x the gradient) within 10% of each
# leaf's largest magnitude and 5% in relative L2 over all leaves.
STEP_LOSS_REL_TOL = 1e-3
STEP_MU_MAX_REL_TOL = 0.1
STEP_MU_L2_REL_TOL = 5e-2
# Adam's first update is lr * g / (|g| + eps): +-lr wherever a gradient is
# nonzero, so the updated params of the two paths are equal or 2 lr apart,
# where the gradient's sign differs (a gradient near 0). At least 99% of the
# trainable params must move the same way (99.8% measured on the H100).
STEP_SAME_DIRECTION_MIN = 0.99
TRAIN_BATCH = 128
TRAIN_IMAGES = 4096  # four optimizer steps of 8 x 128


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_backbone(gen, layers, d, mlp, dev):
    """Stacked block weights in WEIGHT_NAMES order, kernel dtypes, with
    nonzero biases and LN params so every term of the block is exercised."""
    def n(*shape, std):
        return torch.randn(*shape, generator=gen) * std

    wt = (
        1.0 + n(layers, d, std=0.1), n(layers, d, std=0.1),
        n(layers, d, 3 * d, std=0.02), n(layers, 3 * d, std=0.02),
        n(layers, d, d, std=0.02), n(layers, d, std=0.02),
        1.0 + n(layers, d, std=0.1), n(layers, d, std=0.1),
        n(layers, d, mlp, std=0.02), n(layers, mlp, std=0.02),
        n(layers, mlp, d, std=0.02), n(layers, d, std=0.02),
    )
    ln = (0, 1, 6, 7)
    return tuple(
        (t if i in ln else t.to(torch.bfloat16)).to(dev).contiguous()
        for i, t in enumerate(wt)
    )


def library_backbone(x, wt, heads, eps):
    """The same pre-LN stack from PyTorch's library calls (yardstick only)."""
    b, s, d = x.shape
    dh = d // heads
    h = x
    for l in range(wt[0].shape[0]):
        ln1s, ln1b, wqkv, bqkv, wo, bo, ln2s, ln2b, w1, b1, w2, b2 = (
            t[l] for t in wt)
        y = F.layer_norm(h, (d,), ln1s.to(h.dtype), ln1b.to(h.dtype), eps)
        qkv = torch.matmul(y, wqkv) + bqkv
        q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
        att = F.scaled_dot_product_attention(q, k, v)
        h = h + torch.matmul(att.transpose(1, 2).reshape(b, s, d), wo) + bo
        y = F.layer_norm(h, (d,), ln2s.to(h.dtype), ln2b.to(h.dtype), eps)
        h = h + torch.matmul(F.gelu(torch.matmul(y, w1) + b1), w2) + b2
    return h


def backbone_bound_ms(b, s, d, heads, mlp, layers, wt) -> tuple:
    """Least time for one backbone forward: FLOPs over the bf16 peak vs the
    bytes of its inputs (x, weights) read once and its output written once
    over the memory rate. Returns (ms, "operations" | "bytes", flops)."""
    per_layer = (2 * s * d * 3 * d          # QKV
                 + 2 * 2 * s * s * d        # scores and P.V over all heads
                 + 2 * s * d * d            # Wo
                 + 2 * 2 * s * d * mlp)     # W1, W2
    flops = b * layers * per_layer
    nbytes = 2 * b * s * d * 2 + sum(t.numel() * t.element_size() for t in wt)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def stage_breakdown(fn, what: str = "one backbone forward", top: int = 14,
                    wrappers: tuple = ()) -> list:
    """Device time by CUDA kernel name over one call of `fn`, from
    torch.profiler (CUPTI), and, for each name in `wrappers`, the device
    time of the kernels that ran inside that wrapper's `vit2spn::<name>`
    range on the card's timeline; says so when the trace holds no device
    time. Sums every device event of the trace (prof.events())."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, kernels, ranges = {}, [], []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # host ranges, not device work
        t = ev.time_range
        if ev.name.startswith("vit2spn::"):  # a wrapper's range, mirrored on the card
            ranges.append((ev.name, t.start, t.end))
            continue
        kernels.append((t.start, t.elapsed_us()))
        row = by_name.setdefault(ev.name, [0.0, 0])
        row[0] += t.elapsed_us()
        row[1] += 1
    if not kernels:
        return ["[profile] the trace holds no device time: not measured"]
    total = sum(us for us, _ in by_name.values())
    out = [f"[profile] {what}: {total / 1e3:.3f} ms device time "
           f"in {len(kernels)} kernel launches"]
    # one stream: a kernel that starts inside a wrapper's range is its own
    kernels.sort()
    starts = [k[0] for k in kernels]
    spans = {f"vit2spn::{n}": [0.0, 0] for n in wrappers}
    for name, t0, t1 in ranges:
        if name in spans:
            lo, hi = bisect.bisect_left(starts, t0), bisect.bisect_right(starts, t1)
            spans[name][0] += sum(us for _, us in kernels[lo:hi])
            spans[name][1] += 1
    for name, (us, n) in spans.items():
        out.append(f"[profile]   wrapper {name:22s} {us / 1e3:9.3f} ms "
                   f"{100 * us / total:5.1f}% ({n} calls)")
    if spans:
        rest = total - sum(us for us, _ in spans.values())
        out.append(f"[profile]   {'outside the wrappers':30s} {rest / 1e3:9.3f} ms "
                   f"{100 * rest / total:5.1f}% (views, embed, heads, loss, Adam, EMA)")
    for key, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        out.append(f"[profile]   {us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
                   f"x{n:<4d} {key[:90]}")
    return out


def rel_err(a, b) -> tuple:
    """(max, mean) of |a - b| over the largest |b|."""
    diff = (a.float() - b.float()).abs()
    scale = float(b.float().abs().max()) or 1.0
    return float(diff.max()) / scale, float(diff.mean()) / scale


def check_layer_bwd(tag, fb, x, dy, w, heads, eps, fast, against_fp32):
    """Both backward halves of one layer, kernel vs plain twin (and, with
    `against_fp32`, both vs an fp32 backward). Returns each half's largest
    absolute difference."""
    worst = {}
    w32 = {n: t.float() for n, t in w.items()}
    halves = (
        ("mlp_bwd", fb.MLP_NAMES,
         lambda: fb.mlp_bwd(x, dy, w, eps, fast),
         lambda: fb.mlp_bwd_plain(x, dy, w, eps, fast),
         lambda: fb.mlp_bwd_plain(x.float(), dy.float(), w32, eps, fast)),
        ("attn_bwd", fb.ATTN_NAMES,
         lambda: fb.attn_bwd(x, dy, w, heads, eps),
         lambda: fb.attn_bwd_plain(x, dy, w, heads, eps),
         lambda: fb.attn_bwd_plain(x.float(), dy.float(), w32, heads, eps)),
    )
    for name, names, kernel, twin, fp32 in halves:
        got = kernel()
        torch.cuda.synchronize()
        ref = twin()
        ref32 = fp32() if against_fp32 else None
        outs = [("dx", got[0], ref[0], None if ref32 is None else ref32[0])]
        outs += [(n, got[1][n], ref[1][n], None if ref32 is None else ref32[1][n])
                 for n in names]
        worst_rel = 0.0
        for n, a, b, c in outs:
            mx_rel, mean_rel = rel_err(a, b)
            worst[name] = max(worst.get(name, 0.0),
                              float((a.float() - b.float()).abs().max()))
            worst_rel = max(worst_rel, mx_rel)
            if not (mx_rel <= BWD_MAX_REL_TOL and mean_rel <= BWD_MEAN_REL_TOL):
                raise AssertionError(f"{name} disagrees with its plain twin ({tag}, {n}: "
                                     f"max {mx_rel:.3g}, mean {mean_rel:.3g} relative)")
            if c is not None:
                e_k, e_t = rel_err(a, c)[1], rel_err(b, c)[1]
                if not e_k <= KERNEL_VS_FP32_RATIO * e_t + BWD_VS_FP32_SLACK:
                    raise AssertionError(f"{name} is less accurate than its plain twin "
                                         f"({tag}, {n}: {e_k:.3g} vs {e_t:.3g})")
        log(f"[{name}-vs-plain] {tag}: largest relative difference {worst_rel:.3g} "
            f"over dx and {len(names)} weight gradients (tol max {BWD_MAX_REL_TOL}, "
            f"mean {BWD_MEAN_REL_TOL}){'; vs fp32 within the twin' if c is not None else ''}")
    return worst


def layer_weights(names, wt):
    """Layer 0 of stacked block weights, by name."""
    return {n: t[0] for n, t in zip(names, wt)}


def library_mlp_half(x2, dout, w, eps):
    """The MLP half's recompute and backward from PyTorch's library calls
    (yardstick only): torch autograd of F.layer_norm, torch.matmul, F.gelu."""
    leaves = [t.detach().requires_grad_(True) for t in
              (x2, w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["w2"], w["b2"])]
    xx, s_, b_, w1, b1, w2, b2 = leaves
    d = xx.shape[-1]
    y = F.layer_norm(xx, (d,), s_.to(xx.dtype), b_.to(xx.dtype), eps)
    out = xx + torch.matmul(F.gelu(torch.matmul(y, w1) + b1), w2) + b2
    return torch.autograd.grad(out, leaves, dout)


def library_attn_half(x, dx2, w, heads, eps):
    """The attention half's recompute and backward from PyTorch's library
    calls (yardstick only): torch autograd of F.layer_norm, torch.matmul and
    SDPA."""
    leaves = [t.detach().requires_grad_(True) for t in
              (x, w["ln1_scale"], w["ln1_bias"], w["wqkv"], w["bqkv"], w["wo"], w["bo"])]
    xx, s_, b_, wqkv, bqkv, wo, bo = leaves
    b, s, d = xx.shape
    y = F.layer_norm(xx, (d,), s_.to(xx.dtype), b_.to(xx.dtype), eps)
    q, k, v = (torch.matmul(y, wqkv) + bqkv).view(b, s, 3, heads, d // heads).permute(
        2, 0, 3, 1, 4)
    att = F.scaled_dot_product_attention(q, k, v)
    out = xx + torch.matmul(att.transpose(1, 2).reshape(b, s, d), wo) + bo
    return torch.autograd.grad(out, leaves, dx2)


def bwd_bound_ms(kind, b, s, d, heads, mlp, w) -> tuple:
    """Least time for one layer's backward half at batch b: the FLOPs the
    function needs (the recompute of what its inputs do not hold included,
    each product once) over the bf16 peak, vs its inputs read once (x and
    the incoming gradient in bf16, the weights) and its outputs written once
    (dx in bf16, fp32 weight gradients) over the memory rate. Returns (ms,
    "operations" | "bytes", flops)."""
    if kind == "mlp":
        names = ("ln2_scale", "ln2_bias", "w1", "b1", "w2")
        # m1 recompute, dout W2^T, dW2, dW1, dm1 W1^T
        flops = b * 5 * 2 * s * d * mlp
        grads = 2 * d + d * mlp + mlp + mlp * d + d
    else:
        names = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo")
        # qkv recompute, dWqkv and dqkv Wqkv^T; datt and dWo; attention:
        # Q K^T and P V (recompute), dP, dV, dQ, dK
        flops = b * (3 * 2 * s * d * 3 * d + 2 * 2 * s * d * d + 6 * 2 * s * s * d)
        grads = 2 * d + 3 * d * d + 3 * d + d * d + d
    nbytes = (3 * b * s * d * 2 + sum(w[n].numel() * w[n].element_size() for n in names)
              + 4 * grads)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def step_check(cfg, images, eps_lr):
    """Step 1 from the same initial state through the kernels and through
    attn_impl="plain": loss, Adam's first moments, updated params."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    quiet = MetricLogger(echo=False)
    out = {}
    for impl in ("fused", "plain"):
        tr = SSPTrainer(cfg, logger=quiet, attn_impl=impl, device="cuda")
        before = ckpt._flatten(tr.state)
        loss = float(tr.train_step(images, (0, 0))["loss"])
        out[impl] = (loss, before, ckpt._flatten(tr.state))
        del tr
        torch.cuda.empty_cache()
    (lf, before, af), (lp, before_p, ap) = out["fused"], out["plain"]
    assert all(np.array_equal(before[k], before_p[k]) for k in before)
    if not (np.isfinite(lf) and abs(lf - lp) <= STEP_LOSS_REL_TOL * abs(lp)):
        raise AssertionError(f"step 1 loss: kernels {lf} vs plain {lp}")
    mu = [k for k in af if k.startswith("opt_state/0/mu/")]
    worst, num, den = 0.0, 0.0, 0.0
    for k in mu:
        a, b = af[k].astype(np.float64), ap[k].astype(np.float64)
        scale = np.abs(b).max()
        if scale > 0:
            worst = max(worst, np.abs(a - b).max() / scale)
        num += np.sum((a - b) ** 2)
        den += np.sum(b ** 2)
    l2 = math.sqrt(num / den)
    # updated params: both moved by Adam's first step (|update| <= lr) from
    # the same state; the share of elements that moved the same way
    same = total = 0
    for k in af:
        if k.startswith(("params/online/", "params/heads/")):
            da, db = af[k] - before[k], ap[k] - before[k]
            lim = eps_lr * (1 + 1e-3) + 1e-7  # Adam's first step, fp32 rounding
            if np.abs(da).max() > lim or np.abs(db).max() > lim:
                raise AssertionError(f"{k}: a step larger than the learning rate")
            same += int(np.sum(np.sign(da) == np.sign(db)))
            total += da.size
    log(f"[step1-vs-plain] loss kernels {lf:.6f} plain {lp:.6f}; Adam first moments: "
        f"largest difference {worst:.3g} of the leaf's largest, relative L2 {l2:.3g} "
        f"(tol {STEP_MU_MAX_REL_TOL}, {STEP_MU_L2_REL_TOL}); trainable params moved "
        f"the same way in {100.0 * same / total:.2f}% of {total} elements (tol "
        f"{100.0 * STEP_SAME_DIRECTION_MIN:.0f}%)")
    if not (worst <= STEP_MU_MAX_REL_TOL and l2 <= STEP_MU_L2_REL_TOL):
        raise AssertionError("step 1 gradients disagree with the plain path")
    if not same >= STEP_SAME_DIRECTION_MIN * total:
        raise AssertionError("step 1 updated params disagree with the plain path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vit2spn_tpu_torch.core.config import replace
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops import cuda_build
    from vit2spn_tpu_torch.ops import fused_block as fb
    from vit2spn_tpu_torch.ops.fused_block import (
        KERNEL_NAME,
        backbone_forward_plain,
        fast_gelu_default,
        fused_backbone,
        kernel_launches_per_layer,
    )
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all(fb.KERNEL_NAMES)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(fb.KERNEL_NAMES)} in {build_s:.2f} s (in parallel)")
    for name, lib in libs.items():
        for line in open(f"{lib}.log"):
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")

    # -- 3. forward kernel vs plain twin at the serving shapes -----------------
    cfg = replace(get_preset("ssp"), pretrained_init=False)
    vit = cfg.vit
    layers, d, heads, mlp, s = (vit.num_layers, vit.hidden_size, vit.num_heads,
                                vit.mlp_dim, vit.seq_len)
    eps = vit.layernorm_eps
    gen = torch.Generator().manual_seed(SEED)
    wt = random_backbone(gen, layers, d, mlp, dev)
    x = torch.randn(BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
    wt32 = tuple(t.float() for t in wt)
    max_err = 0.0
    for fast in (False, True):
        ref32 = backbone_forward_plain(x.float(), wt32, heads, eps, fast)
        for emit in (False, True):
            got = fused_backbone(x, wt, heads, eps, fast, emit)
            torch.cuda.synchronize()
            ref = backbone_forward_plain(x, wt, heads, eps, fast, emit)
            got = got if emit else (got,)
            ref = ref if emit else (ref,)
            for name, a, b in zip(("out", "xs", "x2s"), got, ref):
                diff = (a.float() - b.float()).abs()
                mx, mean = float(diff.max()), float(diff.mean())
                log(f"[kernel-vs-plain] fast_gelu={fast} emit_res={emit} {name}: "
                    f"max_abs_err {mx:.6g} mean_abs_err {mean:.3g} "
                    f"(max |ref| {float(b.float().abs().max()):.4g}; tol max "
                    f"{KERNEL_MAX_ABS_TOL}, mean {KERNEL_MEAN_ABS_TOL})")
                if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
                    raise AssertionError(
                        f"kernel disagrees with its plain twin ({name}, "
                        f"fast_gelu={fast}, emit_res={emit})")
                max_err = max(max_err, mx)
            err_k = float((got[0].float() - ref32).abs().mean())
            err_p = float((ref[0].float() - ref32).abs().mean())
            log(f"[kernel-vs-fp32] fast_gelu={fast} emit_res={emit}: mean_abs_err "
                f"kernel {err_k:.6g}, plain twin {err_p:.6g} (tol ratio "
                f"{KERNEL_VS_FP32_RATIO})")
            if not err_k <= KERNEL_VS_FP32_RATIO * err_p:
                raise AssertionError("kernel is less accurate than its plain twin")
        del ref32
    # other shapes the kernel takes: ragged M, S < 16 and S = 256, the
    # ViT-Small and ViT-Base widths (1-2 layers, so the same bounds hold)
    for b_, s_, d_, h_, m_, l_ in ((3, 5, 192, 3, 768, 2), (2, 50, 384, 6, 1536, 2),
                                   (1, 256, 192, 3, 768, 1), (5, 17, 768, 12, 3072, 1)):
        wt_ = random_backbone(gen, l_, d_, m_, dev)
        x_ = torch.randn(b_, s_, d_, generator=gen).to(torch.bfloat16).to(dev)
        got = fused_backbone(x_, wt_, h_, eps, True).float()
        torch.cuda.synchronize()
        diff = (got - backbone_forward_plain(x_, wt_, h_, eps, True).float()).abs()
        mx, mean = float(diff.max()), float(diff.mean())
        log(f"[kernel-vs-plain] B={b_} S={s_} D={d_} heads={h_} mlp={m_} L={l_}: "
            f"max_abs_err {mx:.6g} mean_abs_err {mean:.3g}")
        if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
            raise AssertionError(f"kernel disagrees with its plain twin at B={b_} "
                                 f"S={s_} D={d_}")
    lib_out = library_backbone(x, wt, heads, eps)
    plain_out = backbone_forward_plain(x, wt, heads, eps, False)
    log(f"[library-vs-plain] max_abs_err "
        f"{float((lib_out.float() - plain_out.float()).abs().max()):.6g} "
        "(yardstick only; it rounds elsewhere and uses torch's erf gelu)")
    del lib_out, plain_out

    # -- 4. backward kernels vs plain twins ------------------------------------
    wl = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d, mlp, dev))
    xb = torch.randn(TRAIN_BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
    gb = (0.1 * torch.randn(TRAIN_BATCH, s, d, generator=gen)).to(torch.bfloat16).to(dev)
    bwd_err = {"mlp_bwd": 0.0, "attn_bwd": 0.0}
    for fast in (False, True):
        errs = check_layer_bwd(f"B={TRAIN_BATCH} S={s} D={d} fast_gelu={fast}", fb, xb,
                               gb, wl, heads, eps, fast, against_fp32=True)
        bwd_err = {k: max(v, errs[k]) for k, v in bwd_err.items()}
    for b_, s_, d_, h_, m_ in ((3, 5, 192, 3, 768), (2, 17, 192, 3, 768),
                               (1, 256, 192, 3, 768), (5, 50, 384, 6, 1536)):
        w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d_, m_, dev))
        x_ = torch.randn(b_, s_, d_, generator=gen).to(torch.bfloat16).to(dev)
        g_ = (0.1 * torch.randn(b_, s_, d_, generator=gen)).to(torch.bfloat16).to(dev)
        check_layer_bwd(f"B={b_} S={s_} D={d_} heads={h_} mlp={m_}", fb, x_, g_, w_,
                        h_, eps, True, against_fp32=False)
    # the 12-layer backward through the Function, and its determinism
    fast = fast_gelu_default()
    xg = xb.clone().requires_grad_(True)
    wg = tuple(t.clone().requires_grad_(True) for t in wt)
    grads = []
    for _ in range(2):
        out = fused_backbone(xg, wg, heads, eps, fast)
        dx, *dws = torch.autograd.grad(out, (xg, *wg), gb)
        torch.cuda.synchronize()
        grads.append((dx, dws))
    # the forward at the training shape, with the residuals the backward
    # reads, against its plain twin (the forward phase's tolerances)
    got = fused_backbone(xb, wt, heads, eps, fast, emit_res=True)
    torch.cuda.synchronize()
    ref = backbone_forward_plain(xb, wt, heads, eps, fast, emit_res=True)
    for name, a, b in zip(("out", "xs", "x2s"), got, ref):
        diff = (a.float() - b.float()).abs()
        mx, mean = float(diff.max()), float(diff.mean())
        log(f"[kernel-vs-plain] B={TRAIN_BATCH} emit_res=True {name}: max_abs_err "
            f"{mx:.6g} mean_abs_err {mean:.3g} (tol max {KERNEL_MAX_ABS_TOL}, mean "
            f"{KERNEL_MEAN_ABS_TOL})")
        if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
            raise AssertionError(f"kernel disagrees with its plain twin at the training "
                                 f"shape ({name})")
        max_err = max(max_err, mx)
    ref32 = backbone_forward_plain(xb.float(), wt32, heads, eps, fast)
    err_k = float((got[0].float() - ref32).abs().mean())
    err_p = float((ref[0].float() - ref32).abs().mean())
    log(f"[kernel-vs-fp32] B={TRAIN_BATCH} emit_res=True: mean_abs_err kernel "
        f"{err_k:.6g}, plain twin {err_p:.6g} (tol ratio {KERNEL_VS_FP32_RATIO})")
    if not err_k <= KERNEL_VS_FP32_RATIO * err_p:
        raise AssertionError("kernel is less accurate than its plain twin at the "
                             "training shape")
    _, xs, x2s = got
    del ref, ref32
    ref_dx, ref_dw = fb.backbone_backward_plain(xs, x2s, gb, wt, heads, eps, fast)
    worst = (0.0, 0.0)
    for n, a, b in zip(("dx",) + fb.WEIGHT_NAMES, [grads[0][0], *grads[0][1]],
                       [ref_dx, *[t.to(w.dtype) for t, w in zip(ref_dw, wt)]]):
        mx_rel, mean_rel = rel_err(a, b)
        worst = (max(worst[0], mx_rel), max(worst[1], mean_rel))
        if not (mx_rel <= BWD12_MAX_REL_TOL and mean_rel <= BWD12_MEAN_REL_TOL):
            raise AssertionError(f"12-layer backward disagrees with the plain twin at {n}: "
                                 f"max {mx_rel:.3g}, mean {mean_rel:.3g} relative")
    log(f"[backward-12-layers] Function vs backbone_backward_plain, B={TRAIN_BATCH}: "
        f"largest relative difference {worst[0]:.3g}, mean {worst[1]:.3g} over dx and "
        f"12 weight gradients (tol {BWD12_MAX_REL_TOL}, {BWD12_MEAN_REL_TOL})")
    same = all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    same_dx = torch.equal(grads[0][0], grads[1][0])
    log(f"[determinism] two backward runs: weight gradients bitwise equal {same}, "
        f"dx bitwise equal {same_dx}")
    if not (same and same_dx):
        raise AssertionError("the backward is not deterministic")
    del xg, wg, grads, got, xs, x2s, ref_dx, ref_dw

    # -- 5. the serving path end to end --------------------------------------
    ds = synthetic_dataset(split_sizes={"all": N_IMAGES}, image_size=28, seed=SEED)
    quiet = MetricLogger(echo=False)
    trainer = SSPTrainer(cfg, logger=quiet, device="cuda")
    trainer.extract_features(ds, batch_size=BATCH)  # warm-up (allocator, build)
    torch.cuda.synchronize()
    fused_backbone.launches = fb.mlp_bwd.launches = fb.attn_bwd.launches = 0
    t0 = time.perf_counter()
    feats, labels = trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    extract_launches = fused_backbone.launches
    log(f"[extract] {feats.shape} features, {extract_launches} backbone kernel "
        f"launches ({extract_launches * layers * kernel_launches_per_layer()} CUDA "
        f"kernel launches), {extract_s:.3f} s, {N_IMAGES / extract_s:.1f} img/s")
    if extract_launches <= 0:
        raise AssertionError("the serving path never launched the backbone kernel")
    if fb.mlp_bwd.launches or fb.attn_bwd.launches:
        raise AssertionError("the serving path launched a backward kernel")
    if feats.shape != (N_IMAGES, cfg.proj_dim) or not np.isfinite(feats).all():
        raise AssertionError(f"bad features: shape {feats.shape}, "
                             f"finite {np.isfinite(feats).all()}")
    if labels.shape != (N_IMAGES,):
        raise AssertionError(f"bad labels shape {labels.shape}")
    trainer.attn_impl = "plain"
    feats_plain, _ = trainer.extract_features(ds, batch_size=BATCH)
    trainer.attn_impl = "fused"
    scale = float(np.abs(feats_plain).max())
    feat_err = float(np.abs(feats - feats_plain).max())
    log(f"[extract-vs-plain] max_abs_err {feat_err:.6g} (max |plain| {scale:.4g}, "
        f"tol {FEATURE_REL_TOL} relative)")
    if not feat_err <= FEATURE_REL_TOL * scale:
        raise AssertionError("served features disagree with the plain path")
    del trainer

    # -- 6. the training path end to end ---------------------------------------
    tcfg = replace(cfg, batch_size=TRAIN_BATCH)
    eff = tcfg.effective_batch
    tds = synthetic_dataset(split_sizes={"train": TRAIN_IMAGES}, image_size=28,
                            seed=SEED).split("train")
    step_check(tcfg, tds.images[:eff], tcfg.learning_rate)
    torch.cuda.empty_cache()
    trainer = SSPTrainer(tcfg, logger=quiet, device="cuda")
    fused_backbone.launches = fb.mlp_bwd.launches = fb.attn_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = trainer.fit(tds, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = {KERNEL_NAME: fused_backbone.launches,
                      "mlp_bwd": fb.mlp_bwd.launches, "attn_bwd": fb.attn_bwd.launches}
    n_steps = TRAIN_IMAGES // eff
    log(f"[train] fit: {n_steps} optimizer steps of {eff} images in {fit_s:.2f} s "
        f"({TRAIN_IMAGES / fit_s:.1f} img/s, first step included); epoch loss "
        f"{history[0]:.6f}; launches {train_launches}")
    if len(history) != 1 or not np.isfinite(history[0]):
        raise AssertionError(f"training loss is not finite: {history}")
    a = tcfg.accumulation_steps
    want = {KERNEL_NAME: 2 * 2 * a, "mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers}
    for k, per_step in want.items():
        if train_launches[k] != per_step * n_steps:
            raise AssertionError(f"{k}: {train_launches[k]} launches in {n_steps} steps, "
                                 f"expected {per_step} per step")

    # -- 7. times ---------------------------------------------------------------
    fast = fast_gelu_default()
    kernel_ms = time_ms(lambda: fused_backbone(x, wt, heads, eps, fast))
    plain_ms = time_ms(lambda: backbone_forward_plain(x, wt, heads, eps, fast),
                       iters=5, warmup=1)
    with torch.no_grad():
        library_ms = time_ms(lambda: library_backbone(x, wt, heads, eps))
    bound_ms, bound_by, flops = backbone_bound_ms(BATCH, s, d, heads, mlp,
                                                  layers, wt)
    log(f"[time] backbone forward B={BATCH}: kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / (layers * kernel_launches_per_layer()):.4f} ms per CUDA "
        f"launch, {layers * kernel_launches_per_layer()} launches), plain twin "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP), kernel at "
        f"{flops / (kernel_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    for line in stage_breakdown(lambda: fused_backbone(x, wt, heads, eps, fast)):
        log(line)
    entries = [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "vit2spn_tpu_torch/csrc/backbone_fwd.cu",
        "replaces": "vit2spn_tpu/ops/fused_block.py:694",
        "launches": train_launches[KERNEL_NAME], "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }]
    mlp_l, attn_l = fb.backward_launches_per_layer()
    halves = (
        ("mlp_bwd", "vit2spn_tpu/ops/fused_block.py:342", mlp_l,
         lambda: fb.mlp_bwd(xb, gb, wl, eps, fast),
         lambda: fb.mlp_bwd_plain(xb, gb, wl, eps, fast),
         lambda: library_mlp_half(xb, gb, wl, eps)),
        ("attn_bwd", "vit2spn_tpu/ops/fused_block.py:357", attn_l,
         lambda: fb.attn_bwd(xb, gb, wl, heads, eps),
         lambda: fb.attn_bwd_plain(xb, gb, wl, heads, eps),
         lambda: library_attn_half(xb, gb, wl, heads, eps)),
    )
    for name, replaces, per_layer, kernel, twin, library in halves:
        k_ms = time_ms(kernel)
        p_ms = time_ms(twin, iters=5, warmup=1)
        l_ms = time_ms(library)
        b_ms, b_by, b_flops = bwd_bound_ms(name[:-4], TRAIN_BATCH, s, d, heads, mlp, wl)
        log(f"[time] {name} one layer B={TRAIN_BATCH}: kernel {k_ms:.4f} ms "
            f"({per_layer} CUDA launches), plain twin {p_ms:.3f} ms, library "
            f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {b_flops / 1e9:.2f} GFLOP), "
            f"kernel at {b_flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"vit2spn_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": train_launches[name], "max_abs_err": bwd_err[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms,
        })
    fb.mlp_bwd.launches = fb.attn_bwd.launches = 0  # timing launches, not the path's

    trainer_s = SSPTrainer(cfg, logger=quiet, device="cuda")
    fused_backbone.launches = 0  # timing launches are not the serving path's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        trainer_s.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    e2e = reps * N_IMAGES / (time.perf_counter() - t0)
    log(f"[time] extract end to end (dual stream, pred): {e2e:.1f} img/s "
        f"over {reps} x {N_IMAGES} images on {card}")
    del trainer_s

    idx = np.arange(eff)
    trainer.train_step_indices(idx, (1, 0))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for r in range(reps):
        trainer.train_step_indices(idx, (1, 1 + r))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    log(f"[time] optimizer step end to end (dual stream, 8 x {TRAIN_BATCH}, bf16): "
        f"{1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s over {reps} steps on {card}")
    for line in stage_breakdown(lambda: trainer.train_step_indices(idx, (1, 10)),
                                "one optimizer step", wrappers=fb.KERNEL_NAMES):
        log(line)

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
