#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit2spn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from csrc/ (one nvcc per source, all started
     together), with seconds and the compiler's registers, spill stores and
     static shared memory per kernel (of the attention kernels templated on
     S, the instantiation for S = 197; their shared memory is dynamic), and
     the dynamic shared memory of the forward layer's three kernels at
     S = 197;
  3. the backbone-forward kernel against its plain PyTorch twin on the card,
     at the shapes the serving path gives it (ViT-Tiny: L=12, D=192, 3 heads,
     mlp 768, S=197, B=256, bf16), both gelu forms and both emit_res
     settings, and at a few other shapes it takes (ragged batches, short and
     256-token sequences, D = 256, the widest layer kept in one block, and
     the ViT-Small and ViT-Base widths, which take the five-launch layer);
  4. the two backward kernels (one layer's MLP half and attention half)
     against their plain twins at the training shape (ViT-Tiny, B=128), both
     gelu forms, dx and every weight gradient, and as close to an fp32
     backward as the twins are; at S = 5, 17 and 256, a ragged B at S = 197,
     D = 256 and 128 (mlp 320), and the ViT-Small width; two runs of each
     half giving the same bits; the forward kernel at the training shape
     (B=128, emit_res) against its twin, as in phase 3; the 12-layer
     backward through the autograd Function against
     `backbone_backward_plain` on that forward's residuals; two backward
     runs giving the same weight-gradient bits;
  5. the fp32-inside attention kernels (flash forward and backward) against
     their plain twins: o, dq, dk, dv at the training shape (B=128) and the
     serving shape (B=256), at S = 5, 17 and 256, a ragged B, and with fp32
     inputs; at each shape as close to the function computed in float64 as
     the twin is (a kernel that rounded P or dS to bf16 would not be); two
     backward runs at B=128 giving the same dq, dk, dv bits;
  6. the one-layer forward kernel against its twin at B=128 and 256, both
     gelu forms (out and x2), and 12 `fused_block` calls against one
     `fused_backbone`: every output bit equal;
  7. the merged layer backward against the split kernels and its twin, dx
     and all 12 weight gradients: at B=128 (both gelu forms), a ragged B at
     S = 197, D = 128 with mlp 320 and D = 256 every bit must equal the split
     pair's (the same wgmma stages and orders of sums); at the ViT-Small
     width (the mma.sync sequences) the share of equal bits is reported; two
     runs giving the same weight-gradient bits; one call's launches (its
     counter, and 10 CUDA launches: the split pair's 11 less one reduction);
  7b. the fp32 routes of the five fused kernels (compute_dtype=float32)
     against their fp32 twins and against the same twins run in float64: one
     layer of each at B=128 and at the ViT-Small width, the 12-layer forward
     at B=256 (both emit_res settings), the 12-layer backward through the
     Function at B=32; and a launch the C side refuses raises;
  8. the serving path end to end: SSPTrainer on the dual-stream `ssp` preset
     (random init from the seed) runs extract_features over 1024 synthetic
     28 px images at batch 256, through attn_impl "fused", then "pallas" and
     "fused_layer". The launch counters are set to 0 just before each run
     and read just after: only that path's forward kernel ran; the features
     must be finite, (1024, 128), and agree with the same path run through
     the plain twin; then under compute_dtype=float32 through "fused" (the
     fp32 backbone kernel only) against the fp32 plain path;
  9. the training path end to end: `fit` of the `ssp` preset (full width and
     depth, 8 microbatches of 128, bf16) over 4096 synthetic 28 px images,
     four optimizer steps, with the counters set to 0 just before and read
     just after: finite losses, 32 forward launches and 192 launches of each
     backward kernel per step; and step 1 against the same step run with
     attn_impl="plain" from the same state (loss, Adam's first moments, the
     updated params); under compute_dtype=float32, step 1 of "fused" against
     "plain" and one step each of "fused", "fused_layer" and merged "fused"
     with the counters read around it (the fp32 kernels' launches); an
     SSPTrainer with VIT2SPN_VIT_TINY_PATH at an HF-named .npz written from
     seeded random weights records "pretrained" and holds the file's weights
     on the card;
 10. the other backbone paths end to end, at the same width and depth: for
     "pallas", "fused_layer" and "fused" with VIT2SPN_MERGED_BWD=1, step 1
     against a reference path from the same state ("xla", "fused", the
     split backward), then `fit` of two optimizer steps over 2048 images
     with the counters read around it (per step: 384 flash forwards and 192
     flash backwards; 384 layer forwards and 192 of each split half; 32
     backbone forwards and 192 merged backwards, no split half, and the
     merged step's CUDA launches of the backward against the split step's),
     and the step's images/s and device time by wrapper;
 10b. the fine-tune path end to end, at the `ft-octmnist` preset's width and
     depth (B=128, bf16, 4 classes): step 1 of FineTuneTrainer through
     "fused" against "plain" (bf16 and fp32; head dropout on, the same
     streams; loss, Adam's first moments, updated params, BN running
     statistics; in bf16 also each path's distance from the fp32 step and
     the two paths' distance on the blocks) and the split backward against
     VIT2SPN_MERGED_BWD=1 (every bit equal); `evaluate` of 512 images
     through "fused" against "plain" from one state (the backbone forward's
     no-residual route only); a warm step's wall time (beside the same
     steps timed right after the build, and here with the garbage
     collector's objects frozen) and its device time by wrapper (card
     idle); then
     `run ft-octmnist` through the CLI from an export of phase 9's SSP
     trainer, cut to 3 folds and 2 epochs, with the counters set to 0 just
     before and read just after: per train step 1 backbone forward and 12
     of each backward half, per eval batch 1 backbone forward, nothing
     else; its four artifacts, finite fold mAUCs, and per-fold device
     memory that rises by at most one kept model;
 12. the folder datasets and the parity runbook end to end, at the same
     width and depth (bf16), on inputs staged in a temporary directory: an
     octmnist.npz (28 px, 16,384 / 2,048 / 2,048 images, the multitrial
     subset's classes balanced), 572 non-square OCTID files over 5 classes,
     a UCSD train/test tree merged by `data merge-ucsd` into 2,048 files,
     and the seeded HF-layout weight file through VIT2SPN_VIT_TINY_PATH:
     (a) `data stats octid` and the folder decodes' host seconds; (b) the
     folder presets' augmentation at 256 px sources (square with UCSD's
     0.5/0.5 normalization, and a non-square decode) on the card against the
     same function on the CPU from the same parameters; a warm B=128
     ft-ucsdoct step's wall and device time by wrapper (card idle); (c)
     `run ft-ucsdoct` through the CLI, cut to 3 folds and 1 epoch; (d)
     `run_parity(epochs=1, ft_epochs=1)` on the staged root, multitrial
     included: its status equals `compute_status` of the written report,
     init_provenance "pretrained", every stage's entry present; for (c) and
     (d) the launches of backbone_fwd, mlp_bwd and attn_bwd predicted from
     the protocols' sizes, exactly, and no other wrapper; (e) `run ssp
     --profile --epochs 1` on the staged npz: its profile_op lines name the
     three wrappers' ranges, device_memory reads nonzero, model_info's
     backbone GFLOPs equal the products counted here; (f) `convert` of (d)'s
     export to .pth and back with equal leaves, `inspect`, and `plot roc` /
     `cm` of (c)'s cv_result.json;
 11. times with CUDA events after a warm-up: each kernel, its plain twin, a
     library yardstick (F.layer_norm / torch.matmul / SDPA / F.gelu, and
     their torch autograd for the backward kernels; for the flash kernels
     also SDPA on fp32 copies, which keeps P and dS in fp32, with its error
     against float64) and the least time the card could take for the same
     work, for the bf16 kernels and the fp32 routes; the backbone forward's
     device time by CUDA kernel (stage) beside the library yardstick's, at
     B=256; the backward kernels' by stage at B=128 (the bf16 halves and
     merged, the fp32 halves); the fp32 GEMM of every fp32 route alone
     against torch.matmul in fp32 at the backward's shapes, in ms and
     TFLOP/s; extract images/s;
     the "fused"
     optimizer step's images/s, and from torch.profiler its device time by
     kernel wrapper (each wrapper's `vit2spn::<name>` range) and by CUDA
     kernel.

The line before the last is one JSON object {"kernels": [...]} with each
kernel's numbers (`launches` on its training path, `finetune_launches` in
the `run ft-octmnist` of phase 10b, `folder_launches` in phase 12's (c) and
(d)); the last line is {"ok": true, "device": {...}}. The
script needs no network and no JAX, and stops every process it starts.
"""

from __future__ import annotations

import bisect
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): bf16 tensor-core rate, fp32 outside the
# tensor cores (the fp32 routes' rate), and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
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
PATH_IMAGES = 2048  # two optimizer steps of each other backbone path
# The fp32-inside attention kernels vs their plain twins: both compute in
# fp32 and differ in the order of their sums only. bf16 outputs: a value near
# a rounding boundary lands one bf16 step apart, so the largest difference
# may be 1% of the output's largest magnitude (2.5 steps there) and the mean
# 1e-4 of it; fp32 outputs: 1e-5 of it.
FLASH_TOL = {torch.bfloat16: (1e-2, 1e-4), torch.float32: (1e-5, 1e-6)}
# ... and against the function computed in float64 from the same inputs:
# with bf16 outputs the kernel's mean error may be at most 5% above the
# twin's (KERNEL_VS_FP32_RATIO; an attention that rounded P or dS to bf16
# lands further away, as mha_plain shows beside it); with fp32 outputs both
# sit at fp32 roundoff of sums taken in other orders, so the kernel's mean
# error must stay under 1e-6 of the output's largest magnitude.
FLASH_FP32_VS_FP64_TOL = 1e-6
# The fp32 routes (compute_dtype=float32) vs their fp32 twins: every
# rounding point is the identity, so the two differ by float32 sums taken in
# other orders: the largest difference may be 1e-4 of the output's largest
# magnitude for one layer, 1e-3 through 12 layers (forward and backward);
# against the same function in float64 (the twins run in float64) the
# kernel's mean error may be at most 5% above the twin's plus 1e-6 of the
# largest magnitude, where both sit at fp32 roundoff.
FP32_TOL = 1e-4
FP32_TOL_12 = 1e-3
FP32_VS_FP64_SLACK = 1e-6
# Served features through the fp32 kernels vs the fp32 plain path: fp32
# roundoff through 12 layers and the heads, within 1e-4 of the features'
# largest magnitude.
FP32_FEATURE_REL_TOL = 1e-4
FP32_IMAGES = 1024  # one fp32 optimizer step of 8 x 128 per fp32 path
# The pretrained init on the card: a weight file of the HF layout written
# from seeded random weights (no checkpoint is in the repository).
PRETRAINED_SEED = 7
# The fine-tune path (phase 10b): evaluate's probabilities through the
# kernels vs the plain twin, from one state and one eval stream: both round
# the backbone at bf16 and differ as the served features do (FEATURE_REL_TOL
# of their largest magnitude, here 1), so within 2e-2 absolute; the same
# bound for the eval loss, relative.
FT_PROB_TOL = 2e-2
# Step 1 of fine-tuning in bf16 cannot be held to the SSP step's absolute
# tolerances: the BN head makes the backbone's gradient a sum of per-image
# terms that mostly cancel, so bf16 rounding moves it far. On the H100 both
# bf16 paths (the kernels and the plain twin) land ~15% (relative L2) from
# the same step taken in fp32 and ~11% from each other, while the fp32
# routes agree with the fp32 twin within 5e-5. So the bf16 kernels are held
# as close to the fp32 step as the twin is (KERNEL_VS_FP32_RATIO), the test
# every bf16 kernel passes; the fp32 step keeps the STEP_* tolerances.
# The two bf16 paths' distance from each other is held as well, on the
# blocks' first moments (what the backward kernels compute): 0.083 relative L2
# on the H100, held within FT_BLOCKS_MU_L2_TOL, which leaves the kernels no
# bf16 error of their own above ~0.056 (sqrt(0.1**2 - 0.083**2)).
FT_BLOCKS_MU_L2_TOL = 0.1
# The head's first bias feeds train-mode BN, which subtracts the batch mean:
# its true gradient is 0 and both paths hold rounding noise there.
FT_ZERO_GRAD = ("mu/1/linear_0/b",)
FT_EVAL_IMAGES = 512
FT_STEPS = 10  # warm steps timed
FT_FOLDS = 3  # `run ft-octmnist` cut from 10 folds and 50 epochs
FT_EPOCHS = 2
STAGE_CALLS = 10  # calls per traced run of a backward half's stage breakdown


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def ptxas_report(log: str, nt: int) -> list:
    """One line per kernel of a `ptxas -v` log: its registers and spill
    stores. Of a kernel templated on its key tiles (the attention kernels:
    a name with "attention" or "flash" and an int first template argument)
    only the instantiation for `nt` tiles."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            args = re.match(r"I(.*?)E(E|v)", rest)
            tiles = re.match(r"ILi(\d+)E", rest) if re.search("attention|flash", base) else None
            name = None if tiles and int(tiles.group(1)) != nt else base + (
                "<%s>" % ",".join(re.findall(r"L[a-z](\d+)E", args.group(0)) or [args.group(1)])
                if args else "")
            spill = "?"
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores"
                       + (f", {smem.group(1)} B static shared memory" if smem else ""))
            name = None
    return out


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


def backbone_bound_ms(b, s, d, heads, mlp, layers, wt, acts=2) -> tuple:
    """Least time for one backbone forward: FLOPs over the peak of the
    weights' type (bf16 tensor cores, or fp32) vs the bytes of its inputs
    (x, weights) read once and its outputs written once (`acts` (B, S, D)
    activations in all: x and out, and x2 for the one-layer forward) over
    the memory rate. Returns (ms, "operations" | "bytes", flops)."""
    per_layer = (2 * s * d * 3 * d          # QKV
                 + 2 * 2 * s * s * d        # scores and P.V over all heads
                 + 2 * s * d * d            # Wo
                 + 2 * 2 * s * d * mlp)     # W1, W2
    flops = b * layers * per_layer
    width = wt[2].element_size()
    nbytes = acts * b * s * d * width + sum(t.numel() * t.element_size() for t in wt)
    t_ops, t_bytes = flops / peak_flops(wt[2].dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def stage_breakdown(fn, what: str = "one backbone forward", top: int = 14,
                    wrappers: tuple = (), rest: str = "", totals: dict = None) -> list:
    """Device time by CUDA kernel name over one call of `fn`, from
    torch.profiler (CUPTI), and, for each name in `wrappers`, the device
    time of the kernels that ran inside that wrapper's `vit2spn::<name>`
    range on the card's timeline (`rest` names what runs outside them);
    says so when the trace holds no device time. Sums every device event of
    the trace (prof.events()). `totals`, when given, receives the device ms
    ("device") and each wrapper's ("vit2spn::<name>")."""
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
    if totals is not None:
        totals["device"] = total / 1e3
        totals.update({name: us / 1e3 for name, (us, _) in spans.items()})
    if spans:
        outside = total - sum(us for us, _ in spans.values())
        out.append(f"[profile]   {'outside the wrappers':30s} {outside / 1e3:9.3f} ms "
                   f"{100 * outside / total:5.1f}% ({rest})")
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


def check_fp32_layer(tag, fb, x, x2, dy, w, heads, eps, fast, tol=FP32_TOL) -> dict:
    """The fp32 routes of the four one-layer kernels (layer_fwd, mlp_bwd,
    attn_bwd, merged_bwd) against their fp32 twins (largest difference
    within `tol` of each output's largest magnitude) and against the same
    twins run in float64 (mean error at most 5% above the fp32 twin's, plus
    FP32_VS_FP64_SLACK). x, x2, dy fp32; w one layer's weights by name.
    Returns each kernel's largest absolute difference from its twin."""
    w32 = {n: t.float() for n, t in w.items()}
    w64 = {n: t.double() for n, t in w.items()}
    x64, x264, dy64 = x.double(), x2.double(), dy.double()
    wt32 = tuple(w32[n] for n in fb.WEIGHT_NAMES)
    wt64 = tuple(w64[n] for n in fb.WEIGHT_NAMES)

    def flat(out, names):
        return [out[0], *[out[1][n] for n in names]]

    cases = (
        ("layer_fwd", ("out", "x2"),
         lambda: fb.layer_fwd(x, wt32, heads, eps, fast),
         lambda: fb.layer_forward_plain(x, wt32, heads, eps, fast),
         lambda: fb.layer_forward_plain(x64, wt64, heads, eps, fast)),
        ("mlp_bwd", ("dx2",) + fb.MLP_NAMES,
         lambda: flat(fb.mlp_bwd(x2, dy, w32, eps, fast), fb.MLP_NAMES),
         lambda: flat(fb.mlp_bwd_plain(x2, dy, w32, eps, fast), fb.MLP_NAMES),
         lambda: flat(fb.mlp_bwd_plain(x264, dy64, w64, eps, fast), fb.MLP_NAMES)),
        ("attn_bwd", ("dx",) + fb.ATTN_NAMES,
         lambda: flat(fb.attn_bwd(x, dy, w32, heads, eps), fb.ATTN_NAMES),
         lambda: flat(fb.attn_bwd_plain(x, dy, w32, heads, eps), fb.ATTN_NAMES),
         lambda: flat(fb.attn_bwd_plain(x64, dy64, w64, heads, eps), fb.ATTN_NAMES)),
        ("merged_bwd", ("dx",) + fb.WEIGHT_NAMES,
         lambda: flat(fb.merged_bwd(x, x2, dy, w32, heads, eps, fast), fb.WEIGHT_NAMES),
         lambda: flat(fb.merged_bwd_plain(x, x2, dy, w32, heads, eps, fast), fb.WEIGHT_NAMES),
         lambda: flat(fb.merged_bwd_plain(x64, x264, dy64, w64, heads, eps, fast),
                      fb.WEIGHT_NAMES)),
    )
    worst = {}
    for name, names, kernel, twin, ref64 in cases:
        before = getattr(fb, name).launches
        got = kernel()
        torch.cuda.synchronize()
        if getattr(fb, name).launches != before + 1:
            raise AssertionError(f"{name} fp32 did not launch its kernel ({tag})")
        worst[name] = check_fp32_outputs(f"{name}-fp32", tag, names, got, twin(), ref64(), tol)
    return worst


def check_fp32_outputs(what, tag, names, got, ref, ref64, tol) -> float:
    """fp32 outputs against the fp32 twin's and the float64 twin's (see
    check_fp32_layer). Returns the largest absolute difference."""
    worst, worst_rel, ratio = 0.0, 0.0, 0.0
    for n, a, b, c in zip(names, got, ref, ref64):
        if a.dtype != torch.float32:
            raise AssertionError(f"{what} gave {n} in {a.dtype} ({tag})")
        mx_rel = rel_err(a, b)[0]
        if not mx_rel <= tol:
            raise AssertionError(f"{what} disagrees with its fp32 twin ({tag}, {n}: "
                                 f"{mx_rel:.3g} of the largest magnitude, tol {tol})")
        e_k, e_t = mean_rel64(a, c.double()), mean_rel64(b, c.double())
        if not e_k <= KERNEL_VS_FP32_RATIO * e_t + FP32_VS_FP64_SLACK:
            raise AssertionError(f"{what} is less accurate than its fp32 twin against float64 "
                                 f"({tag}, {n}: {e_k:.3g} vs {e_t:.3g})")
        worst = max(worst, float((a - b).abs().max()))
        worst_rel = max(worst_rel, mx_rel)
        ratio = max(ratio, e_k / e_t if e_t else 0.0)
    log(f"[{what}-vs-plain] {tag}: largest relative difference {worst_rel:.3g} over "
        f"{len(names)} outputs (tol {tol}); mean error vs float64 at most {ratio:.3f}x the "
        f"fp32 twin's (tol {KERNEL_VS_FP32_RATIO}x + {FP32_VS_FP64_SLACK})")
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


def peak_flops(dtype) -> float:
    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def bwd_bound_ms(kind, b, s, d, heads, mlp, w) -> tuple:
    """Least time for one layer's backward half ("mlp", "attn") or whole
    backward ("merged") at batch b: the FLOPs the function needs (the
    recompute of what its inputs do not hold included, each product once)
    over the bf16 peak, vs its inputs read once (x, x2 and the incoming
    gradient in bf16, the weights) and its outputs written once (dx in bf16,
    fp32 weight gradients) over the memory rate. Returns (ms, "operations" |
    "bytes", flops)."""
    if kind == "merged":
        mlp_flops = bwd_bound_ms("mlp", b, s, d, heads, mlp, w)[2]
        attn_flops = bwd_bound_ms("attn", b, s, d, heads, mlp, w)[2]
        flops = mlp_flops + attn_flops
        grads = sum(t.numel() for t in w.values())
        nbytes = (4 * b * s * d * w["w1"].element_size()
                  + sum(t.numel() * t.element_size() for t in w.values()) + 4 * grads)
        t_ops, t_bytes = flops / peak_flops(w["w1"].dtype), nbytes / PEAK_BYTES
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops
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
    nbytes = (3 * b * s * d * w[names[2]].element_size()
              + sum(w[n].numel() * w[n].element_size() for n in names) + 4 * grads)
    t_ops, t_bytes = flops / peak_flops(w[names[2]].dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from vit2spn_tpu_torch.ops import flash_attention as fa
    from vit2spn_tpu_torch.ops import fused_block as fb

    return {"backbone_fwd": fb.fused_backbone, "layer_fwd": fb.layer_fwd,
            "mlp_bwd": fb.mlp_bwd, "attn_bwd": fb.attn_bwd, "merged_bwd": fb.merged_bwd,
            "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd}


def reset_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def attention_fp64(q, k, v, do):
    """Attention and its backward computed in float64 on the card, from the
    inputs as they are (the reference the fp32-inside kernels and their
    twins are both held against). Returns (o, dq, dk, dv)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return o, dq, dk, dv


def mean_rel64(a, ref) -> float:
    """mean |a - ref| over the largest |ref|, in float64."""
    return float((a.double() - ref).abs().mean()) / (float(ref.abs().max()) or 1.0)


def flash_operands(gen, b, s, heads, dtype, dev):
    """q, k, v as the per-op block hands them to attention (views of one
    (B, S, 3D) qkv, read in place) and an output gradient."""
    d = heads * 64
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(dtype).to(dev)
    q, k, v = (t.reshape(b, s, heads, 64) for t in qkv.split(d, dim=-1))
    do = (0.1 * torch.randn(b, s, heads, 64, generator=gen)).to(dtype).to(dev)
    return q, k, v, do


def check_flash(tag, q, k, v, do) -> dict:
    """Both flash kernels against their plain twins and against float64.
    Returns the largest absolute difference of each kernel from its twin."""
    from vit2spn_tpu_torch.ops import flash_attention as fa
    from vit2spn_tpu_torch.ops.attention import mha_plain

    got = (fa.flash_fwd(q, k, v), *fa.flash_bwd(q, k, v, do))
    torch.cuda.synchronize()
    ref = (fa.flash_attention_plain(q, k, v), *fa.flash_attention_bwd_plain(q, k, v, do))
    ref64 = attention_fp64(q, k, v, do)
    max_tol, mean_tol = FLASH_TOL[q.dtype]
    worst, errs = {"flash_fwd": 0.0, "flash_bwd": 0.0}, []
    for name, a, b, c in zip(("o", "dq", "dk", "dv"), got, ref, ref64):
        mx, mean = rel_err(a, b)
        if not (mx <= max_tol and mean <= mean_tol):
            raise AssertionError(f"flash kernel disagrees with its plain twin ({tag}, {name}: "
                                 f"max {mx:.3g}, mean {mean:.3g} relative)")
        e_k, e_t = mean_rel64(a, c), mean_rel64(b, c)
        ok = (e_k <= KERNEL_VS_FP32_RATIO * e_t if q.dtype == torch.bfloat16
              else e_k <= FLASH_FP32_VS_FP64_TOL)
        if not ok:
            raise AssertionError(f"flash kernel is further from float64 than its twin "
                                 f"({tag}, {name}: {e_k:.4g} vs {e_t:.4g})")
        key = "flash_fwd" if name == "o" else "flash_bwd"
        worst[key] = max(worst[key], float((a.float() - b.float()).abs().max()))
        errs.append(f"{name} {mx:.3g}/{e_k:.3g}/{e_t:.3g}")
    line = (f"[flash-vs-plain] {tag}: largest relative difference / mean error vs float64 "
            f"kernel / twin: {', '.join(errs)} (tol {max_tol}, {mean_tol}; ")
    line += ("ratio %s)" % KERNEL_VS_FP32_RATIO if q.dtype == torch.bfloat16
             else "%g)" % FLASH_FP32_VS_FP64_TOL)
    if q.dtype == torch.bfloat16:  # what rounding P to bf16 would cost
        line += f"; mha_plain (bf16 P) {mean_rel64(mha_plain(q, k, v), ref64[0]):.3g}"
    log(line)
    return worst


def check_layer_fwd(tag, fb, x, w, heads, eps, fast) -> float:
    """The one-layer forward kernel against `layer_forward_plain` (out and
    x2), and as close to an fp32 layer as the twin. Returns the largest
    absolute difference."""
    got = fb.layer_fwd(x, w, heads, eps, fast)
    torch.cuda.synchronize()
    ref = fb.layer_forward_plain(x, w, heads, eps, fast)
    ref32 = fb.layer_forward_plain(x.float(), tuple(t.float() for t in w), heads, eps, fast)
    worst = 0.0
    for name, a, b, c in zip(("out", "x2"), got, ref, ref32):
        diff = (a.float() - b.float()).abs()
        mx, mean = float(diff.max()), float(diff.mean())
        e_k, e_t = float((a.float() - c).abs().mean()), float((b.float() - c).abs().mean())
        log(f"[layer_fwd-vs-plain] {tag} {name}: max_abs_err {mx:.6g} mean_abs_err "
            f"{mean:.3g}; vs fp32 kernel {e_k:.6g}, twin {e_t:.6g} (tol max "
            f"{KERNEL_MAX_ABS_TOL}, mean {KERNEL_MEAN_ABS_TOL}, ratio {KERNEL_VS_FP32_RATIO})")
        if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
            raise AssertionError(f"layer kernel disagrees with its plain twin ({tag}, {name})")
        if not e_k <= KERNEL_VS_FP32_RATIO * e_t:
            raise AssertionError(f"layer kernel is less accurate than its twin ({tag}, {name})")
        worst = max(worst, mx)
    return worst


def equal_bits(a, b) -> float:
    """The share of elements of two tensors of one dtype that are equal bit
    for bit."""
    ia = a.contiguous().view(torch.int16 if a.element_size() == 2 else torch.int32)
    ib = b.contiguous().view(torch.int16 if b.element_size() == 2 else torch.int32)
    return float((ia == ib).float().mean())


def check_merged_bwd(tag, fb, x, x2, dy, w, heads, eps, fast, equal) -> float:
    """The merged layer backward against the split kernels (the share of
    equal bits, which must be 100% with `equal`, and the split tolerances)
    and against `merged_bwd_plain` (and as close to an fp32 backward as it).
    Returns the largest absolute difference from the twin."""
    dx, grads = fb.merged_bwd(x, x2, dy, w, heads, eps, fast)
    torch.cuda.synchronize()
    dx2, mgrads = fb.mlp_bwd(x2, dy, w, eps, fast)
    sdx, sgrads = fb.attn_bwd(x, dx2, w, heads, eps)
    sgrads = {**mgrads, **sgrads}
    rdx, rgrads = fb.merged_bwd_plain(x, x2, dy, w, heads, eps, fast)
    w32 = {n: t.float() for n, t in w.items()}
    fdx, fgrads = fb.merged_bwd_plain(x.float(), x2.float(), dy.float(), w32, heads, eps, fast)
    worst, worst_rel, shares = 0.0, 0.0, []
    for n in ("dx",) + fb.WEIGHT_NAMES:
        a, s_, b, c = ((dx, sdx, rdx, fdx) if n == "dx"
                       else (grads[n], sgrads[n], rgrads[n], fgrads[n]))
        shares.append(equal_bits(a, s_))
        for ref, what in ((b, "its plain twin"), (s_, "the split kernels")):
            mx_rel, mean_rel = rel_err(a, ref)
            if not (mx_rel <= BWD_MAX_REL_TOL and mean_rel <= BWD_MEAN_REL_TOL):
                raise AssertionError(f"merged_bwd disagrees with {what} ({tag}, {n}: max "
                                     f"{mx_rel:.3g}, mean {mean_rel:.3g} relative)")
        e_k, e_t = rel_err(a, c)[1], rel_err(b, c)[1]
        if not e_k <= KERNEL_VS_FP32_RATIO * e_t + BWD_VS_FP32_SLACK:
            raise AssertionError(f"merged_bwd is less accurate than its twin ({tag}, {n})")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        worst_rel = max(worst_rel, rel_err(a, b)[0])
    log(f"[merged_bwd-vs-plain] {tag}: largest relative difference {worst_rel:.3g} over dx "
        f"and 12 weight gradients (tol max {BWD_MAX_REL_TOL}, mean {BWD_MEAN_REL_TOL}); vs "
        f"fp32 within the twin; equal bits with the split kernels: "
        f"{100.0 * min(shares):.4f}% (least over the 13 outputs"
        + ("; must be 100%: the same stages and orders of sums)" if equal else ")"))
    if equal and min(shares) != 1.0:
        raise AssertionError(f"merged_bwd differs from the split kernels bit for bit ({tag})")
    return worst


def time_gemm_f32(fb, m, d, mlp, gen, dev) -> None:
    """The fp32 GEMM that every fp32 route runs, alone, at the backward's
    shapes over m token rows, against torch.matmul in fp32 (TF32 off): C = A
    B and C = A B^T at (N, K) = (3 d, d), (d, d), (mlp, d), (d, mlp), and the
    weight-gradient form [A | 1]^T B with the token rows split (C's last row
    B's column sums) at (K1, N) = (d, 3 d), (d, d), (d, mlp), (mlp, d). Each
    within FP32_TOL of the largest magnitude of torch's result."""
    lib = fb._load("mlp_bwd")
    stream = torch.cuda.current_stream().cuda_stream

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    cases = []
    for form, (n, k) in ((0, (3 * d, d)), (1, (d, d)), (0, (mlp, d)), (1, (d, mlp))):
        a, b = rnd(m, k), rnd(*((k, n) if form == 0 else (n, k)))
        c = torch.empty(m, n, device=dev)
        lib_fn = (lambda a=a, b=b: a @ b) if form == 0 else (lambda a=a, b=b: a @ b.t())
        cases.append((("A B", "A B^T")[form], form, m, n, k, a, b, c, None, lib_fn))
    for k1, n in ((d, 3 * d), (d, d), (d, mlp), (mlp, d)):
        a, b = rnd(m, k1), rnd(m, n)
        c = torch.empty(k1 + 1, n, device=dev)
        ws = torch.empty(lib.vit2spn_gemm_f32_workspace_floats(k1, n, m), device=dev)
        lib_fn = (lambda a=a, b=b: torch.cat([a.t() @ b, b.sum(0, keepdim=True)]))
        cases.append(("[A|1]^T B", 2, k1, n, m, a, b, c, ws, lib_fn))
    for what, form, mm, n, k, a, b, c, ws, lib_fn in cases:
        def kernel(a=a, b=b, c=c, ws=ws, mm=mm, n=n, k=k, form=form):
            fb._raise_on(lib, lib.vit2spn_gemm_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                   None if ws is None else ws.data_ptr(),
                                                   mm, n, k, form, stream), "fp32 GEMM")
        kernel()
        torch.cuda.synchronize()
        ref = lib_fn()
        err = rel_err(c, ref)[0]
        k_ms, l_ms = time_ms(kernel), time_ms(lib_fn)
        flops = 2.0 * mm * n * k
        log(f"[time] fp32 GEMM {what} M={mm} N={n} K={k}: kernel {k_ms:.4f} ms "
            f"({flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s), torch.matmul {l_ms:.4f} ms "
            f"({flops / (l_ms * 1e-3) / 1e12:.1f} TFLOP/s); largest difference {err:.3g} of "
            f"the largest magnitude (tol {FP32_TOL})")
        if not err <= FP32_TOL:
            raise AssertionError(f"the fp32 GEMM disagrees with torch.matmul ({what}, N={n})")


def rel_l2(a: dict, b: dict, keys) -> float:
    """Relative L2 distance of a's leaves from b's over `keys`, in float64."""
    num = sum(np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in keys)
    den = sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys)
    return math.sqrt(num / den)


def compare_steps(tag, names, runs, eps_lr, params, stats=(), skip=()) -> None:
    """Step 1 of two paths from one state. `runs` holds (loss, flat state
    before, flat state after) per path, path first; `params` the prefixes of
    the trainable leaves, `stats` those of running statistics. The loss
    within STEP_LOSS_REL_TOL; Adam's first moments and each statistic's move
    within STEP_MU_MAX_REL_TOL of the leaf's largest and STEP_MU_L2_REL_TOL
    in relative L2; the updated params moved the same way in at least
    STEP_SAME_DIRECTION_MIN of the elements, none by more than the lr.
    Moments of the leaves in `skip` (whose true gradient is 0, so both
    paths hold rounding noise there) are not compared."""
    (lf, before, af), (lp, before_p, ap) = runs
    assert all(np.array_equal(before[k], before_p[k]) for k in before)
    if not (np.isfinite(lf) and abs(lf - lp) <= STEP_LOSS_REL_TOL * abs(lp)):
        raise AssertionError(f"step 1 loss: {names[0]} {lf} vs {names[1]} {lp}")

    def moved(keys, delta):
        worst, num, den = 0.0, 0.0, 0.0
        for k in keys:
            a, b = delta(af, k), delta(ap, k)
            scale = np.abs(b).max()
            if scale > 0:
                worst = max(worst, np.abs(a - b).max() / scale)
            num += np.sum((a - b) ** 2)
            den += np.sum(b ** 2)
        return worst, math.sqrt(num / den)

    mu = [k for k in af if k.startswith("opt_state/") and "/mu/" in k
          and not k.endswith(skip)]
    worst, l2 = moved(mu, lambda st, k: st[k].astype(np.float64))
    # updated params: both moved by Adam's first step (|update| <= lr) from
    # the same state; the share of elements that moved the same way
    same = total = 0
    for k in af:
        if k.startswith(params):
            da, db = af[k] - before[k], ap[k] - before[k]
            lim = eps_lr * (1 + 1e-3) + 1e-7  # Adam's first step, fp32 rounding
            if np.abs(da).max() > lim or np.abs(db).max() > lim:
                raise AssertionError(f"{k}: a step larger than the learning rate")
            same += int(np.sum(np.sign(da) == np.sign(db)))
            total += da.size
    line = (f"[{tag}-{names[0].replace(' ', '-')}-vs-{names[1].replace(' ', '-')}] loss "
            f"{names[0]} {lf:.6f} {names[1]} {lp:.6f}; Adam first moments: "
            f"largest difference {worst:.3g} of the leaf's largest, relative L2 {l2:.3g} "
            f"(tol {STEP_MU_MAX_REL_TOL}, {STEP_MU_L2_REL_TOL}); trainable params moved "
            f"the same way in {100.0 * same / total:.2f}% of {total} elements (tol "
            f"{100.0 * STEP_SAME_DIRECTION_MIN:.0f}%)")
    s_worst = s_l2 = 0.0
    if stats:  # running statistics: their move from the shared start
        s_worst, s_l2 = moved([k for k in af if k.startswith(stats) and af[k].dtype.kind == "f"],
                              lambda st, k: st[k].astype(np.float64) - before[k])
        line += (f"; running statistics' move: largest difference {s_worst:.3g}, relative "
                 f"L2 {s_l2:.3g}")
    log(line)
    if not (worst <= STEP_MU_MAX_REL_TOL and l2 <= STEP_MU_L2_REL_TOL):
        raise AssertionError(f"step 1 gradients of {names[0]} disagree with {names[1]}")
    if not (s_worst <= STEP_MU_MAX_REL_TOL and s_l2 <= STEP_MU_L2_REL_TOL):
        raise AssertionError(f"step 1 running statistics of {names[0]} disagree with "
                             f"{names[1]}")
    if not same >= STEP_SAME_DIRECTION_MIN * total:
        raise AssertionError(f"step 1 updated params of {names[0]} disagree with {names[1]}")


def path_name(impl, merged, cfg) -> str:
    return f"{impl}{' merged' if merged else ''}{' fp32' if cfg.compute_dtype == 'float32' else ''}"


def step_check(cfg, images, eps_lr, path=("fused", False), ref=("plain", False)):
    """SSP step 1 from the same initial state through `path` and through the
    reference path `ref`, each (attn_impl, merged backward): loss, Adam's
    first moments, updated params."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    quiet = MetricLogger(echo=False)
    out = []
    for impl, merged in (path, ref):
        os.environ["VIT2SPN_MERGED_BWD"] = "1" if merged else "0"
        tr = SSPTrainer(cfg, logger=quiet, attn_impl=impl, device="cuda")
        before = ckpt._flatten(tr.state)
        loss = float(tr.train_step(images, (0, 0))["loss"])
        out.append((loss, before, ckpt._flatten(tr.state)))
        del tr
        torch.cuda.empty_cache()
    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    compare_steps("step1", [path_name(*p, cfg) for p in (path, ref)], out, eps_lr,
                  ("params/online/", "params/heads/"))


def pretrained_state(vit) -> dict:
    """HF-named ViT-Tiny weights (numpy) from a seeded random backbone: the
    stand-in for the published checkpoint, which is not in the repository."""
    from vit2spn_tpu_torch.models import hf_convert
    from vit2spn_tpu_torch.models.vit import init_vit

    params = init_vit(torch.Generator().manual_seed(PRETRAINED_SEED), vit, device="cpu")
    return hf_convert.convert_to_hf_state_dict(params, vit)


def check_pretrained_init(cfg, dev) -> None:
    """SSPTrainer with pretrained_init and $VIT2SPN_VIT_TINY_PATH at an .npz
    of HF-named ViT-Tiny weights this script writes from a seeded random
    backbone (no checkpoint is in the repository): the trainer must record
    "pretrained" and start every online and target backbone on the card from
    the file's weights, exactly."""
    import tempfile

    from vit2spn_tpu_torch.models import hf_convert
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    def numpy_tree(t):
        return ({k: numpy_tree(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().cpu().numpy())

    state = pretrained_state(cfg.vit)
    want = hf_convert.convert_hf_state_dict(state, cfg.vit)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "vit_tiny.npz")
        np.savez(path, **state)
        old = os.environ.get("VIT2SPN_VIT_TINY_PATH")
        os.environ["VIT2SPN_VIT_TINY_PATH"] = path
        try:
            tr = SSPTrainer(replace_cfg(cfg, pretrained_init=True),
                            logger=MetricLogger(echo=False), device="cuda")
        finally:
            if old is None:
                del os.environ["VIT2SPN_VIT_TINY_PATH"]
            else:
                os.environ["VIT2SPN_VIT_TINY_PATH"] = old
    n_leaves = 0
    for net_name, net in (("online", tr.params.online), ("target", tr.params.target)):
        got = numpy_tree(net)

        def walk(g, w, key):
            nonlocal n_leaves
            if isinstance(w, dict):
                for k in w:
                    walk(g[k], w[k], f"{key}/{k}")
                return
            for i in range(g.shape[0]):  # every stream
                if not np.array_equal(g[i], w):
                    raise AssertionError(f"pretrained init: {net_name}{key} differs from the "
                                         "weight file")
            n_leaves += 1

        walk(got, want, "")
    if tr.init_provenance != "pretrained" or tr.params.online["blocks"]["w1"].device != dev:
        raise AssertionError(f"pretrained init: provenance {tr.init_provenance!r}")
    log(f"[pretrained] SSPTrainer with VIT2SPN_VIT_TINY_PATH at an HF-named .npz (seed "
        f"{PRETRAINED_SEED}): init_provenance {tr.init_provenance!r}; {n_leaves} backbone "
        f"leaves of the online and target nets on {dev} equal the file's bit for bit")


def ft_step_check(cfg, ds, weights, path=("fused", False), ref=("plain", False),
                  against_fp32: bool = False) -> float:
    """Fine-tune step 1 (one batch of `ds`, head dropout on, the same
    augment and dropout streams) from one initial state through `path` and
    through `ref`, each (attn_impl, merged backward). Without
    `against_fp32`: loss, Adam's first moments, updated params and the BN
    running statistics under compare_steps' tolerances. With it (the bf16
    kernels against the bf16 plain twin): the loss and the BN statistics so,
    and `path` at least as close to the step taken in fp32 (the plain path
    with compute_dtype=float32, from the same state) as `ref` is, within
    KERNEL_VS_FP32_RATIO: Adam's first moments in relative L2 (all trainable
    leaves, and the blocks the backward kernels compute) and the share of
    elements that moved against the fp32 step. Returns the share of equal
    bits of `path`'s and `ref`'s updated states."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    quiet = MetricLogger(echo=False)
    idx = np.arange(cfg.batch_size)[None]
    out = []
    runs = [(cfg, *path), (cfg, *ref)]
    if against_fp32:
        runs.append((replace_cfg(cfg, compute_dtype="float32"), "plain", False))
    for rcfg, impl, merged in runs:
        os.environ["VIT2SPN_MERGED_BWD"] = "1" if merged else "0"
        tr = FineTuneTrainer(rcfg, ds.num_classes, logger=quiet, attn_impl=impl,
                             device="cuda")
        before = {k: v.copy() for k, v in ckpt._flatten(tr.state).items()}
        loss = float(tr.train_epoch(ds, idx, weights, epoch=0))
        out.append((loss, before, ckpt._flatten(tr.state)))
        del tr
        torch.cuda.empty_cache()
    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    names = [path_name(*p, cfg) for p in (path, ref)]
    if not against_fp32:
        compare_steps("ft-step1", names, out, cfg.learning_rate, ("backbone/", "head/"),
                      ("bn_state/",), skip=FT_ZERO_GRAD)
    else:
        (lf, before, af), (lp, before_p, ap), (l32, before32, a32) = out
        assert all(np.array_equal(before[k], before_p[k]) for k in before)
        assert all(np.array_equal(before[k], before32[k]) for k in before)
        if not (np.isfinite(lf) and abs(lf - lp) <= STEP_LOSS_REL_TOL * abs(lp)):
            raise AssertionError(f"step 1 loss: {names[0]} {lf} vs {names[1]} {lp}")
        mu = [k for k in af if k.startswith("opt_state/") and "/mu/" in k
              and not k.endswith(FT_ZERO_GRAD)]
        blocks = [k for k in mu if "/blocks/" in k]
        dist = {n: (rel_l2(st, a32, mu), rel_l2(st, a32, blocks)) for n, st in zip(names, (af, ap))}
        blocks_l2 = rel_l2(af, ap, blocks)
        stats = [k for k in af if k.startswith("bn_state/") and af[k].dtype.kind == "f"]
        moved = {k: af[k] - before[k] for k in stats}
        s_l2 = rel_l2(moved, {k: ap[k] - before[k] for k in stats}, stats)
        against, total = {}, 0
        for n, st in zip(names, (af, ap)):
            against[n] = 0
            for k in st:
                if k.startswith(("backbone/", "head/")):
                    d, d32 = st[k] - before[k], a32[k] - before[k]
                    if np.abs(d).max() > cfg.learning_rate * (1 + 1e-3) + 1e-7:
                        raise AssertionError(f"{k}: a step larger than the learning rate")
                    against[n] += int(np.sum(np.sign(d) != np.sign(d32)))
                    total += d.size if n == names[0] else 0
        log(f"[ft-step1-{names[0]}-vs-{names[1]}] loss {lf:.6f} vs {lp:.6f} (fp32 step "
            f"{l32:.6f}); Adam first moments' relative L2 from the fp32 step, all leaves / the "
            f"blocks: {names[0]} {dist[names[0]][0]:.4f} / {dist[names[0]][1]:.4f}, {names[1]} "
            f"{dist[names[1]][0]:.4f} / {dist[names[1]][1]:.4f}, {names[0]} vs {names[1]} "
            f"{rel_l2(af, ap, mu):.4f} / {blocks_l2:.4f} (tol on the blocks "
            f"{FT_BLOCKS_MU_L2_TOL}); params moved against the fp32 step in "
            f"{100.0 * against[names[0]] / total:.3f}% / {100.0 * against[names[1]] / total:.3f}%"
            f" of {total} elements; BN statistics' move, relative L2 {s_l2:.3g} (tol "
            f"{STEP_MU_L2_REL_TOL}); ratio tol {KERNEL_VS_FP32_RATIO}")
        if not all(a <= KERNEL_VS_FP32_RATIO * b
                   for a, b in zip(dist[names[0]], dist[names[1]])):
            raise AssertionError(f"step 1 gradients of {names[0]} are further from the fp32 "
                                 f"step than {names[1]}'s")
        if not blocks_l2 <= FT_BLOCKS_MU_L2_TOL:
            raise AssertionError(f"step 1 gradients of the blocks: {names[0]} and {names[1]} "
                                 f"are {blocks_l2:.4f} apart")
        if not against[names[0]] <= KERNEL_VS_FP32_RATIO * against[names[1]] + 1e-4 * total:
            raise AssertionError(f"step 1 of {names[0]} moves against the fp32 step more "
                                 f"often than {names[1]}")
        if not s_l2 <= STEP_MU_L2_REL_TOL:
            raise AssertionError(f"step 1 BN statistics of {names[0]} disagree with {names[1]}")
    af, ap = out[0][2], out[1][2]
    floats = [k for k in af if af[k].dtype.kind == "f"]
    equal = sum(int(np.sum(af[k] == ap[k])) for k in floats) / sum(af[k].size for k in floats)
    log(f"[ft-step1] {names[0]} vs {names[1]}: {100.0 * equal:.4f}% of the updated "
        "state's elements bit-equal")
    return equal


def ft_data():
    """The fine-tune phases' preset, FT_EVAL_IMAGES seeded synthetic images
    and their balanced class weights."""
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.train.optim import balanced_class_weights

    ds = synthetic_dataset(split_sizes={"train": FT_EVAL_IMAGES}, image_size=28,
                           seed=SEED + 3).split("train")
    return get_preset("ft-octmnist"), ds, balanced_class_weights(ds.labels, ds.num_classes)


def ft_step_wall(tf, ds, w) -> float:
    """Wall seconds per warm fine-tune step of trainer `tf`: FT_STEPS steps
    after two warm-up steps, the card synced around them."""
    bs = tf.cfg.batch_size
    idx = np.arange(FT_STEPS * bs).reshape(FT_STEPS, bs) % len(ds)
    tf.train_epoch(ds, idx[:2], w, epoch=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.train_epoch(ds, idx, w, epoch=2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / FT_STEPS


def ft_step_wall_fresh() -> float:
    """ft_step_wall of a new "fused" FineTuneTrainer, run right after the
    build so that no earlier phase has left state in the process."""
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg, ds, w = ft_data()
    tf = FineTuneTrainer(cfg, ds.num_classes, logger=MetricLogger(echo=False), device="cuda")
    step_s = ft_step_wall(tf, ds, w)
    del tf
    torch.cuda.empty_cache()
    return step_s


def finetune_path(ssp_trainer, card, fresh_s) -> dict:
    """The fine-tune path end to end at full width and depth (the
    `ft-octmnist` preset: ViT-Tiny/16, 224 px, 12 layers, B=128, bf16, 4
    classes): (a) step 1 of FineTuneTrainer through "fused" against "plain"
    in bf16 and fp32, and the split backward against the merged one; (b)
    `evaluate` of FT_EVAL_IMAGES images through "fused" against "plain" from
    one state, and its img/s; (d) a warm step's wall time and its device
    time by wrapper, the card's idle share; (c) `run ft-octmnist` through
    the CLI from the export of `ssp_trainer`, cut to FT_FOLDS folds and
    FT_EPOCHS epochs, with the launch counters read around it. `fresh_s` is
    ft_step_wall_fresh's reading, printed beside this phase's. Returns the
    run's launches by kernel."""
    import tempfile

    from vit2spn_tpu_torch.cli import main as cli_main
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg, ds, w = ft_data()
    bs, layers = cfg.batch_size, cfg.vit.num_layers

    # (a) step 1 against a reference path from one state
    ft_step_check(cfg, ds, w, against_fp32=True)
    ft_step_check(replace_cfg(cfg, compute_dtype="float32"), ds, w)
    equal = ft_step_check(cfg, ds, w, ("fused", True), ("fused", False))
    if equal != 1.0:
        raise AssertionError(f"fine-tune step 1: the merged backward's state differs from the "
                             f"split pair's ({100.0 * equal:.4f}% of the elements bit-equal)")

    # (b) evaluate: "fused" against "plain" from one state (one step taken,
    # so the BN running statistics are off their init)
    quiet = MetricLogger(echo=False)
    tf = FineTuneTrainer(cfg, ds.num_classes, logger=quiet, device="cuda")
    tf.train_epoch(ds, np.arange(bs)[None], w, epoch=0)
    tp = FineTuneTrainer(cfg, ds.num_classes, logger=quiet, attn_impl="plain", device="cuda")
    tp.state = tf.state
    tf.evaluate(ds, w)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss_f, probs_f, labels = tf.evaluate(ds, w)
    eval_s = time.perf_counter() - t0
    eval_launches = {k: n for k, n in read_launches().items() if n}
    loss_p, probs_p, _ = tp.evaluate(ds, w)
    del tp
    err = float(np.abs(probs_f - probs_p).max())
    agree = float(np.mean(probs_f.argmax(1) == probs_p.argmax(1)))
    n_eval = -(-len(ds) // bs)
    log(f"[ft-eval] evaluate of {len(ds)} images (eval augmentation on, one stream): fused vs "
        f"plain probabilities max_abs_err {err:.4g} (tol {FT_PROB_TOL}), equal argmax "
        f"{100.0 * agree:.2f}%, loss {loss_f:.6f} vs {loss_p:.6f}; launches {eval_launches}; "
        f"{1e3 * eval_s:.2f} ms, {len(ds) / eval_s:.1f} img/s on {card}")
    if probs_f.shape != (len(ds), ds.num_classes) or not np.isfinite(probs_f).all():
        raise AssertionError(f"bad eval probabilities: shape {probs_f.shape}")
    if eval_launches != {KERNEL_NAME: n_eval}:
        raise AssertionError(f"evaluate launched {eval_launches}, expected {n_eval} "
                             f"{KERNEL_NAME} (its no-residual route) and nothing else")
    if not (err <= FT_PROB_TOL and abs(loss_f - loss_p) <= FT_PROB_TOL * max(1.0, abs(loss_p))):
        raise AssertionError("fine-tune evaluate through fused disagrees with plain")

    # (d) a warm step: wall time over FT_STEPS steps (and again with the
    # earlier phases' Python objects frozen out of the garbage collector's
    # scans), device time by wrapper
    step_s = ft_step_wall(tf, ds, w)
    gc.collect()
    gc.freeze()
    frozen_s = ft_step_wall(tf, ds, w)
    gc.unfreeze()
    totals = {}
    lines = stage_breakdown(lambda: tf.train_epoch(ds, np.arange(bs)[None], w, epoch=3),
                            f"one fine-tune step (B={bs}, bf16)",
                            wrappers=(KERNEL_NAME, "mlp_bwd", "attn_bwd"),
                            rest="views, embed, head, loss, Adam", totals=totals)
    for line in lines:
        log(line)
    def idle(wall_s):
        return (f"{100.0 * (1.0 - totals['device'] / (1e3 * wall_s)):.1f}%" if totals
                else "not measured")

    log(f"[time] fine-tune step (B={bs}, bf16): wall {1e3 * step_s:.3f} ms over {FT_STEPS} "
        f"warm steps, {bs / step_s:.1f} img/s; device "
        f"{totals.get('device', float('nan')):.3f} ms; card idle {idle(step_s)} on {card}")
    log(f"[time] fine-tune step wall, same steps: right after the build, before the other "
        f"phases {1e3 * fresh_s:.3f} ms ({bs / fresh_s:.1f} img/s, card idle {idle(fresh_s)}); "
        f"here with the garbage collector's objects frozen {1e3 * frozen_s:.3f} ms "
        f"({bs / frozen_s:.1f} img/s, card idle {idle(frozen_s)}); {len(gc.get_objects())} "
        f"objects tracked here")
    state_bytes = 3 * 4 * sum(t.numel() for t in tf._trainable)  # params, 2 moments
    del tf
    torch.cuda.empty_cache()

    # (c) the CLI end to end from an SSP export
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        export = ssp_trainer.export_backbone(os.path.join(tmp, "ssp_export.npz"))
        out = os.path.join(tmp, "ft")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["run", "ft-octmnist", "--epochs", str(FT_EPOCHS), "--output-dir", out,
                       "-o", f"k_folds={FT_FOLDS}", "-o", f"init_path={export}"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        missing = [a for a in ("roc_curve_all_folds.png", "confusion_matrix.png",
                               "classification_report.txt", "cv_result.json")
                   if not os.path.getsize(os.path.join(out, f"octmnist_{a}"))]
    if rc != 0 or missing:
        raise AssertionError(f"run ft-octmnist: rc {rc}, empty artifacts {missing}")
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    sizes = by["protocol"][0]
    n_cv, n_test = sizes["cv_size"], sizes["test_size"]
    # the stratified deal is one round robin over the subset: fold f holds
    # positions f, f + k, ...
    steps = evals = 0
    for f in range(FT_FOLDS):
        n_val = len(range(f, n_cv, FT_FOLDS))
        epochs = len(by.get(f"fold{f}_epoch", []))
        steps += epochs * max((n_cv - n_val) // bs, 1)
        evals += (epochs + 1) * -(-n_val // bs)  # per epoch, then the fold's ROC
    evals += -(-n_test // bs)  # the best fold's model on the test set
    want = {KERNEL_NAME: steps + evals, "mlp_bwd": layers * steps, "attn_bwd": layers * steps}
    aucs = [e["mauc"] for e in by.get("fold_result", [])]
    mem = by.get("fold_memory", [])
    peaks = [e["peak_allocated_bytes"] for e in mem]
    held = [e["allocated_bytes"] for e in mem]
    warm = [e["images_per_sec"] for k, v in by.items() if k.endswith("_epoch")
            for e in v if e["epoch"] == FT_EPOCHS]
    summary = by.get("cv_summary", [{}])[0]
    log(f"[finetune] run ft-octmnist (cut: {FT_FOLDS} folds, {FT_EPOCHS} epochs; subset "
        f"{n_cv}, test {n_test}, width and depth the preset's) from the SSP export in "
        f"{run_s:.1f} s: {steps} train steps, {evals} eval batches; launches "
        f"{ {k: n for k, n in launches.items() if n} } (expected {want}); fold mAUCs {aucs}; "
        f"test accuracy {summary.get('test_accuracy')}; per-fold peak / held MiB "
        f"{[round(p / 2**20, 1) for p in peaks]} / {[round(h / 2**20, 1) for h in held]}; "
        f"warm-epoch train img/s {[round(x, 1) for x in warm]} on {card}")
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"run ft-octmnist launched {launches}, expected {want}")
    if len(aucs) != FT_FOLDS or not all(np.isfinite(aucs)) or "cv_summary" not in by:
        raise AssertionError(f"run ft-octmnist: fold mAUCs {aucs}, events {sorted(by)}")
    # fold 0 holds one model; from fold 1 on, the best so far may be kept
    # beside the current one: memory may sit one model's state (params and
    # two Adam moments, plus 8 MiB of staged folds) above fold 0's, never more
    slack = 1.1 * state_bytes + 8 * 2**20
    if len(peaks) != FT_FOLDS or any(p > peaks[0] + slack for p in peaks) \
            or any(h > held[0] + slack for h in held):
        raise AssertionError(f"per-fold device memory grows: peaks {peaks}, held {held} "
                             f"(one model's state {state_bytes} bytes)")
    return {k: n for k, n in launches.items() if n}


# Phase 12: the folder datasets and the parity runbook, on inputs staged here
FOLDER_SPLITS = {"train": 16384, "val": 2048, "test": 2048}  # the staged octmnist.npz
OCTID_FILES = 572  # over 5 classes, as the OCTID loader's synthetic stand-in
OCTID_HW = (288, 384)  # (H, W) of the staged OCTID files: not square
UCSD_FILES = {"train": 480, "test": 32}  # per class: 2,048 merged over 4 classes
UCSD_HW = (300, 320)
FOLDER_FOLDS = 3  # `run ft-ucsdoct` cut from 10 folds
FOLDER_STEP_IMAGES = 512  # the 256 px fine-tune step's dataset
# The augmentation at 256 px sources on the card against the same function on
# the CPU from the same parameters: fp32 differs by the order of sums of the
# band limit's and the resize's products and the warp's bilinear weights
# (max 1e-4 absolute on normalized pixels, mean 1e-6); in bf16 a sum that
# lands near a rounding boundary of the band-limited source moves one bf16
# step, which the warp carries: at most 4 steps at |x| < 4 (0.0625), mean 1e-3.
AUG_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (0.0625, 1e-3)}


def _smooth_image(rng, hw, cls) -> np.ndarray:
    """A smooth grayscale image whose stripe frequency codes the class (it
    compresses to a small JPEG)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    theta, phase = rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * 2.0 * (1.8 ** cls) * (xx * np.cos(theta) + yy * np.sin(theta))
                  + phase)
    return (255 * (0.5 + 0.4 * wave)).astype(np.uint8)


def stage_folder_inputs(root: str) -> None:
    """Writes under `root`: octmnist.npz (medmnist keys, 28 px, 4 classes,
    FOLDER_SPLITS; the multitrial preset's subset, the protocol's first draw
    at the preset's seed, holds each class a quarter of the time, so each of
    its 10 folds holds every class); octird/<class>/ with OCTID_FILES
    non-square JPEGs over 5 classes; ucsdoct/{train,test}/<class>/ with
    UCSD_FILES JPEGs per class, for `data merge-ucsd`."""
    from PIL import Image

    from vit2spn_tpu_torch.core.presets import get_preset

    rng = np.random.default_rng(SEED + 12)
    arrs = {}
    for split, n in FOLDER_SPLITS.items():
        labels = rng.permutation(np.arange(n) % 4)
        if split == "train":
            mt = get_preset("multitrial/ft-octmnist")
            sub = np.random.default_rng(mt.seed).choice(
                n, int(n * mt.data.subset_fraction), replace=False)
            labels[sub] = np.arange(len(sub)) % 4
        noise = rng.integers(0, 96, (n, 28, 28), dtype=np.uint8)
        arrs[f"{split}_images"] = noise + (40 * labels).astype(np.uint8)[:, None, None]
        arrs[f"{split}_labels"] = labels.reshape(-1, 1)
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "octmnist.npz"), **arrs)
    for i in range(OCTID_FILES):
        cls = i % 5
        d = os.path.join(root, "octird", ("amd", "csr", "dr", "mh", "normal")[cls])
        os.makedirs(d, exist_ok=True)
        Image.fromarray(_smooth_image(rng, OCTID_HW, cls), "L").save(
            os.path.join(d, f"{i:04d}.jpg"))
    for split, n in UCSD_FILES.items():
        for cls, name in enumerate(("CNV", "DME", "DRUSEN", "NORMAL")):
            d = os.path.join(root, "ucsdoct", split, name)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                Image.fromarray(_smooth_image(rng, UCSD_HW, cls), "L").save(
                    os.path.join(d, f"{name}-{split}-{i:04d}.jpeg"))


def protocol_launches(cfg, ds, epochs: int, per_fold_test: bool = False) -> tuple:
    """Predicted (train steps, eval batches, cv size, test size) of one
    run_cv_protocol of `cfg` over `ds`: the protocol's own subsets and folds;
    per fold `epochs` epochs of max(n_train // B, 1) steps, an evaluation of
    the val fold after each epoch and one more for its ROC (with
    `per_fold_test`, one of the test set too); then the best fold's model on
    the test set. No early stop can end an epoch count this short."""
    from vit2spn_tpu_torch.evals.kfold import stratified_kfold
    from vit2spn_tpu_torch.evals.protocol import select_subsets

    cv, test = select_subsets(cfg, ds)
    bs = cfg.batch_size
    n_test = -(-len(test) // bs)
    steps = evals = 0
    for tr, va in stratified_kfold(cv.labels, cfg.k_folds, seed=cfg.seed):
        steps += epochs * max(len(tr) // bs, 1)
        evals += (epochs + 1) * -(-len(va) // bs) + (n_test if per_fold_test else 0)
    return steps, evals + n_test, len(cv), len(test)


def _wanted(steps: int, evals: int, layers: int, backbone_calls: int = 0, bwd_calls: int = 0):
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME

    return {KERNEL_NAME: backbone_calls + steps + evals, "mlp_bwd": bwd_calls + layers * steps,
            "attn_bwd": bwd_calls + layers * steps}


def check_launches(what: str, launches: dict, want: dict) -> None:
    ran = {k: n for k, n in launches.items() if n}
    log(f"[folder] {what}: launches {ran} (predicted {want})")
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"{what} launched {ran}, predicted {want} and no other wrapper")


def check_folder_augment(dev) -> None:
    """The folder presets' augmentation at 256 px sources (square, UCSD's
    0.5/0.5 normalization; and a non-square (H, W) decode) on the card
    against the same function on the CPU, from the same parameters drawn on
    the CPU: the band limit's pre-shrink and squash, the warp, jitter, blur,
    erasing and both output forms, in fp32 and bf16 (AUG_TOL)."""
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data import augment as aug

    rng = np.random.default_rng(SEED + 13)
    for preset, hw in (("ft-ucsdoct", (256, 256)), ("ft-octid", (248, 256))):
        cfg = get_preset(preset).data.augment
        u8 = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH,) + hw + (1,), dtype=np.uint8))
        p = aug.sample_params(torch.Generator().manual_seed(SEED), TRAIN_BATCH, cfg,
                              (cfg.out_size, cfg.out_size))
        for dtype in (torch.float32, torch.bfloat16):
            for fold in (True, False):
                outs = []
                for d in ("cpu", dev):
                    gray = aug._band_limit(aug._to_gray(u8.to(d)).to(dtype), cfg.band_limit)
                    pd = aug.AugParams(*(t.to(d) for t in p))
                    outs.append(aug._normalize(aug.apply_params(gray, pd, cfg), cfg, dtype,
                                               fold).float().cpu())
                err = (outs[1] - outs[0]).abs()
                tol_max, tol_mean = AUG_TOL[str(dtype).split(".")[1]]
                log(f"[folder-aug] {preset} {hw[0]}x{hw[1]} -> {cfg.out_size} px, {dtype}, "
                    f"{'pre-normalize' if fold else 'normalized'} (mean {cfg.normalize_mean[0]}): "
                    f"card vs CPU max_abs_err {float(err.max()):.4g} (tol {tol_max}), mean "
                    f"{float(err.mean()):.4g} (tol {tol_mean})")
                if not (float(err.max()) <= tol_max and float(err.mean()) <= tol_mean):
                    raise AssertionError(f"the augmentation at {hw} px disagrees with the CPU")


def folder_path(ssp_trainer, card) -> dict:
    """Phase 12: the folder datasets and the parity runbook at the full
    ViT-Tiny width and depth, bf16, on the card, from inputs staged in a
    temporary directory (stage_folder_inputs; the seeded HF-layout weight
    file through VIT2SPN_VIT_TINY_PATH). Returns the launches of (c) and (d)
    by kernel."""
    import contextlib
    import io
    import tempfile

    from vit2spn_tpu_torch.cli import main as cli_main
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.evals.parity import compute_status, run_parity
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.train.optim import balanced_class_weights
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    t_phase = time.perf_counter()
    quiet = MetricLogger(echo=False)
    vit = ssp_trainer.cfg.vit
    layers = vit.num_layers
    total = {}
    old_weights = os.environ.get("VIT2SPN_VIT_TINY_PATH")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        root = os.path.join(tmp, "datasets")
        t0 = time.perf_counter()
        stage_folder_inputs(root)
        weights = os.path.join(tmp, "vit_tiny.npz")
        np.savez(weights, **pretrained_state(vit))
        os.environ["VIT2SPN_VIT_TINY_PATH"] = weights
        with contextlib.redirect_stdout(io.StringIO()) as merged:
            rc = cli_main(["data", "merge-ucsd", os.path.join(root, "ucsdoct")])
        stats = json.loads(merged.getvalue())
        log(f"[folder] staged octmnist.npz {FOLDER_SPLITS}, {OCTID_FILES} OCTID files "
            f"{OCTID_HW[1]}x{OCTID_HW[0]}, UCSD train/test {UCSD_FILES} per class merged by "
            f"`data merge-ucsd` (rc {rc}) into {stats} in {time.perf_counter() - t0:.2f} s (host)")
        if rc != 0 or sum(stats.values()) != 4 * sum(UCSD_FILES.values()):
            raise AssertionError(f"data merge-ucsd: rc {rc}, {stats}")
        # (a) `data stats octid`, and the folder decodes' host seconds alone
        out_a = os.path.join(tmp, "stats")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["data", "stats", "octid", "--root", root, "--out", out_a])
        with open(os.path.join(out_a, "octid_dataset_summary.json")) as f:
            summary = json.load(f)
        log(f"[folder] data stats octid: rc {rc}, {summary['num_samples']} images, classes "
            f"{summary['class_distribution']}, raw {summary['image_properties']['avg_width']:.0f}"
            f"x{summary['image_properties']['avg_height']:.0f}, decoded "
            f"{summary['image_size']}")
        if rc != 0 or summary["num_samples"] != OCTID_FILES or not all(
                os.path.getsize(os.path.join(out_a, f"octid_{n}.png"))
                for n in ("samples", "distribution")):
            raise AssertionError(f"data stats octid: rc {rc}, {summary}")
        loaded, decode = {}, {}
        for name in ("octid", "ucsdoct"):
            t0 = time.perf_counter()
            loaded[name] = load_dataset(name, root=root, allow_synthetic=False)
            decode[name] = time.perf_counter() - t0
        log("[time] folder decode on the host (PIL, grayscale, bilinear to 256 px): "
            + ", ".join(f"{k} {len(loaded[k])} files in {sec:.3f} s "
                        f"({len(loaded[k]) / sec:.0f} files/s)" for k, sec in decode.items()))
        octid, ucsd = loaded["octid"], loaded["ucsdoct"]
        if ucsd.class_names != ["CNV", "DME", "DRUSEN", "NORMAL"]:
            raise AssertionError(f"the merged UCSD folder loads as {ucsd.class_names}")

        # (b) the augmentation at 256 px sources, card vs CPU
        check_folder_augment(torch.device("cuda", 0))

        # a warm B=128 ft-ucsdoct step: device time by wrapper and its wall
        cfg_u = get_preset("ft-ucsdoct")
        sds = ucsd.subset(np.arange(FOLDER_STEP_IMAGES))
        w = balanced_class_weights(sds.labels, sds.num_classes)
        tf = FineTuneTrainer(cfg_u, sds.num_classes, logger=quiet, device="cuda")
        step_s = ft_step_wall(tf, sds, w)
        totals = {}
        bs = cfg_u.batch_size
        for line in stage_breakdown(lambda: tf.train_epoch(sds, np.arange(bs)[None], w, epoch=3),
                                    f"one ft-ucsdoct step (B={bs}, bf16, 256 px sources)",
                                    wrappers=(KERNEL_NAME, "mlp_bwd", "attn_bwd"),
                                    rest="views at 256 px, embed, head, loss, Adam",
                                    totals=totals):
            log(line)
        idle = (f"{100.0 * (1.0 - totals['device'] / (1e3 * step_s)):.1f}%" if totals
                else "not measured")
        log(f"[time] ft-ucsdoct step (B={bs}, bf16, 256 px sources): wall {1e3 * step_s:.3f} "
            f"ms over {FT_STEPS} warm steps, {bs / step_s:.1f} img/s; device "
            f"{totals.get('device', float('nan')):.3f} ms; card idle {idle} on {card} "
            f"(the 28 px ft-octmnist step of phase 10b beside it)")
        del tf
        torch.cuda.empty_cache()

        # (c) `run ft-ucsdoct` through the CLI, cut to FOLDER_FOLDS folds, 1 epoch
        export = ssp_trainer.export_backbone(os.path.join(tmp, "ssp_export.npz"))
        cfg_c = replace_cfg(cfg_u, k_folds=FOLDER_FOLDS)
        steps, evals, n_cv, n_test = protocol_launches(cfg_c, ucsd, 1)
        want_c = _wanted(steps, evals, layers)
        out_c = os.path.join(tmp, "ft_ucsdoct")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["run", "ft-ucsdoct", "--epochs", "1", "--output-dir", out_c,
                           "-o", f"k_folds={FOLDER_FOLDS}", "-o", f"data.root={root}",
                           "-o", f"init_path={export}"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches_c = read_launches()
        with open(os.path.join(out_c, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        sizes = next(e for e in events if e["event"] == "protocol")
        aucs = [e["mauc"] for e in events if e["event"] == "fold_result"]
        mem = [round(e["peak_allocated_bytes"] / 2**20, 1) for e in events
               if e["event"] == "fold_memory"]
        log(f"[folder] run ft-ucsdoct (cut: {FOLDER_FOLDS} folds, 1 epoch; subset {n_cv}, "
            f"test {n_test} predicted, {sizes['cv_size']} / {sizes['test_size']} run) in "
            f"{run_s:.1f} s: {steps} train steps, {evals} eval batches; fold mAUCs {aucs}; "
            f"per-fold peak MiB {mem} on {card}")
        if rc != 0 or (sizes["cv_size"], sizes["test_size"]) != (n_cv, n_test) \
                or len(aucs) != FOLDER_FOLDS or not all(np.isfinite(aucs)):
            raise AssertionError(f"run ft-ucsdoct: rc {rc}, sizes {sizes}, aucs {aucs}")
        check_launches("run ft-ucsdoct", launches_c, want_c)

        # (d) the parity runbook on the staged root, multitrial included
        octm = load_dataset("octmnist", root=root, allow_synthetic=False)
        ssp_steps = len(octm.split("train")) // ssp_trainer.cfg.effective_batch
        a = ssp_trainer.cfg.accumulation_steps
        probe = 2 * -(-min(256, len(octm.split("train"))) // 128)  # 2 streams per batch
        parts = [protocol_launches(get_preset(n), d, 1) for n, d in (
            ("ft-octmnist", octm), ("ft-octid", octid), ("ft-ucsdoct", ucsd))]
        mt = get_preset("multitrial/ft-octmnist")
        parts += [protocol_launches(mt, octm, 1, per_fold_test=True)] * mt.num_trials
        want_d = _wanted(sum(p[0] for p in parts), sum(p[1] for p in parts), layers,
                         backbone_calls=ssp_steps * 2 * 2 * a + probe,
                         bwd_calls=ssp_steps * 2 * a * layers)
        out_d = os.path.join(tmp, "parity")
        os.makedirs(out_d)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        report = run_parity(data_root=root, out_dir=out_d, epochs=1, ft_epochs=1,
                            logger=MetricLogger(os.path.join(out_d, "parity_metrics.jsonl"),
                                                echo=False))
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t0
        launches_d = read_launches()
        with open(os.path.join(out_d, "parity_report.json")) as f:
            written = json.load(f)
        log(f"[parity] run_parity(epochs=1, ft_epochs=1) on the staged root in {parity_s:.1f} s: "
            f"status {report['status']!r}; inputs {report['inputs']}; ssp "
            f"{ {k: v for k, v in report['ssp'].items() if k != 'export'} }; "
            + "; ".join(f"{k} mAUC {e['measured_mauc']:.4f} acc {e['measured_accuracy']:.4f}"
                        for k, e in report["datasets"].items())
            + f"; multitrial {report.get('multitrial')}; {ssp_steps} SSP steps, fine-tune "
            f"protocols (steps, evals, cv, test) {parts[:4]} and {mt.num_trials - 1} more trials")
        if report["status"] != compute_status(written) or written["status"] != report["status"]:
            raise AssertionError(f"parity status {report['status']!r} is not compute_status "
                                 f"of its report ({compute_status(written)!r})")
        if report["ssp"]["init_provenance"] != "pretrained" or not all(report["inputs"].values()) \
                or set(report["datasets"]) != {"octmnist", "octid", "ucsdoct"} \
                or "multitrial" not in report or report["ssp"]["epochs_run"] != 1:
            raise AssertionError(f"parity report incomplete: {written}")
        check_launches("run_parity", launches_d, want_d)
        total = {k: launches_c[k] + launches_d[k] for k in launches_c}

        # (e) `run ssp --profile --epochs 1` on the staged npz
        out_e = os.path.join(tmp, "ssp_profile")
        t0 = time.perf_counter()
        rc = cli_main(["run", "ssp", "--profile", "--epochs", "1", "--output-dir", out_e,
                       "-o", f"data.root={root}"])
        prof_s = time.perf_counter() - t0
        with open(os.path.join(out_e, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        ops = [e for e in events if e["event"] == "profile_op"]
        info = next(e for e in events if e["event"] == "model_info")
        mem = next((e for e in events if e["event"] == "device_memory"), {})
        s, d, mlp = vit.seq_len, vit.hidden_size, vit.mlp_dim
        backbone = (2 * (s - 1) * vit.patch_size ** 2 * 3 * d
                    + layers * (2 * s * d * 3 * d + 2 * 2 * s * s * d + 2 * s * d * d
                                + 2 * 2 * s * d * mlp))
        cost = next(e for e in events if e["event"] == "profile_trace")
        fit = [e for e in events if e["event"] == "ssp_epoch"]
        log(f"[profile] run ssp --profile --epochs 1: rc {rc} in {prof_s:.1f} s (the epoch "
            f"{fit[0]['seconds']:.1f} s under the profiler; the trace {cost['mib']:.1f} MiB "
            f"gzipped, written in {cost['write_s']:.1f} s and read back in "
            f"{cost['read_s']:.1f} s); profile_op "
            + "; ".join(f"{e['source']} {e['total_us'] / 1e3:.3f} ms x{e['count']}" for e in ops))
        log(f"[profile] model_info { {k: v for k, v in info.items() if k not in ('event', 'time')} }"
            f" (one backbone's products counted here: {backbone / 1e9:.4f} GFLOP); "
            f"device_memory {mem.get('0')}")
        names = {e["source"] for e in ops}
        missing = [f"vit2spn::{k}" for k in (KERNEL_NAME, "mlp_bwd", "attn_bwd")
                   if f"vit2spn::{k}" not in names]
        if rc != 0 or missing:
            raise AssertionError(f"run ssp --profile: rc {rc}, profile_op lacks {missing}")
        if info["backbone_gflops"] != round(backbone / 1e9, 4) \
                or not mem.get("0", {}).get("bytes_in_use_mb", 0) > 0:
            raise AssertionError(f"model_info {info} / device_memory {mem}")

        # (f) convert (d)'s export to .pth and back, inspect, plot (c)'s result
        src = report["ssp"]["export"]
        pth, back = os.path.join(tmp, "export.pth"), os.path.join(tmp, "export_back.npz")
        with contextlib.redirect_stdout(io.StringIO()) as text, \
                contextlib.redirect_stderr(io.StringIO()):
            rcs = [cli_main(["convert", src, pth]), cli_main(["convert", pth, back]),
                   cli_main(["inspect", pth]),
                   cli_main(["plot", "roc", "--result",
                             os.path.join(out_c, "ucsdoct_cv_result.json"),
                             "--out", os.path.join(tmp, "roc.png")]),
                   cli_main(["plot", "cm", "--result",
                             os.path.join(out_c, "ucsdoct_cv_result.json"),
                             "--out", os.path.join(tmp, "cm.png")])]
        with np.load(src) as a_, np.load(back) as b_:
            keys = [k for k in a_.files if k != "__metadata__"]
            equal = sorted(keys) == sorted(k for k in b_.files if k != "__metadata__") and all(
                np.array_equal(a_[k], b_[k]) for k in keys)
        rows = [line for line in text.getvalue().splitlines() if "  (" in line]
        n_hf = len(torch.load(pth, weights_only=True))
        log(f"[folder] convert export -> .pth -> .npz: {len(keys)} leaves equal {equal}; "
            f"inspect .pth: {len(rows)} arrays of {n_hf}; plot roc / cm: rcs {rcs}")
        if rcs != [0] * 5 or not equal or len(rows) != n_hf or not all(
                os.path.getsize(os.path.join(tmp, n)) for n in ("roc.png", "cm.png")):
            raise AssertionError(f"convert / inspect / plot: rcs {rcs}, leaves equal {equal}")
    if old_weights is None:
        del os.environ["VIT2SPN_VIT_TINY_PATH"]
    else:
        os.environ["VIT2SPN_VIT_TINY_PATH"] = old_weights
    log(f"[folder] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return {k: n for k, n in total.items() if n}


def replace_cfg(cfg, **kw):
    from vit2spn_tpu_torch.core.config import replace

    return replace(cfg, **kw)


def fit_path(tcfg, tds, impl, merged, per_step) -> tuple:
    """`fit` of one epoch over `tds` through one backbone path, with the
    launch counters set to 0 just before and read just after; every counter
    must read `per_step` (missing: 0) times the steps. Returns (trainer,
    launches, seconds)."""
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    os.environ["VIT2SPN_MERGED_BWD"] = "1" if merged else "0"
    trainer = SSPTrainer(tcfg, logger=MetricLogger(echo=False), attn_impl=impl, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.fit(tds, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    eff = tcfg.effective_batch
    n_steps = len(tds) // eff
    name = f"{impl}{' merged' if merged else ''}{' fp32' if tcfg.compute_dtype == 'float32' else ''}"
    log(f"[train] {name}: fit of {n_steps} optimizer steps of {eff} images in {fit_s:.2f} s "
        f"({len(tds) / fit_s:.1f} img/s, first step included); epoch loss "
        f"{history[0]:.6f}; launches {launches}")
    if len(history) != 1 or not np.isfinite(history[0]):
        raise AssertionError(f"{name}: training loss is not finite: {history}")
    for k, n in launches.items():
        if n != per_step.get(k, 0) * n_steps:
            raise AssertionError(f"{name}: {k} launched {n} times in {n_steps} steps, "
                                 f"expected {per_step.get(k, 0)} per step")
    return trainer, launches, fit_s


def time_steps(trainer, eff, name, card, wrappers, rest, reps=3) -> float:
    """The optimizer step's wall time over `reps` steps after a warm-up, and
    its device time by wrapper range (`rest` names what runs outside the
    wrappers). Returns the step's seconds."""
    idx = np.arange(eff)
    trainer.train_step_indices(idx, (1, 0))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(reps):
        trainer.train_step_indices(idx, (1, 1 + r))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    log(f"[time] optimizer step {name} (dual stream, 8 x {TRAIN_BATCH}, bf16): "
        f"{1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s over {reps} steps on {card}")
    for line in stage_breakdown(lambda: trainer.train_step_indices(idx, (1, 10)),
                                f"one optimizer step ({name})", wrappers=wrappers, rest=rest):
        log(line)
    return step_s


def extract_path(trainer, ds, impl, feats_plain, want, tol=FEATURE_REL_TOL,
                 what=None) -> np.ndarray:
    """extract_features through one backbone path, with the launch counters
    set to 0 just before and read just after: the kernels in `want` must
    have run and no other; the features must be finite and agree with the
    plain path's within `tol` of their largest magnitude. Returns the
    features."""
    what = what or impl
    trainer.attn_impl = impl
    reset_launches()
    t0 = time.perf_counter()
    feats, _ = trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if n}
    scale = float(np.abs(feats_plain).max())
    err = float(np.abs(feats - feats_plain).max())
    log(f"[extract] {what}: {feats.shape} features, launches {launches}, {extract_s:.3f} s, "
        f"{len(ds) / extract_s:.1f} img/s; vs plain max_abs_err {err:.6g} (max |plain| "
        f"{scale:.4g}, tol {tol} relative)")
    if set(launches) != set(want):
        raise AssertionError(f"extract through {what} launched {launches}, expected {want}")
    if feats.shape != feats_plain.shape or not np.isfinite(feats).all():
        raise AssertionError(f"bad features through {what}: shape {feats.shape}")
    if not err <= tol * scale:
        raise AssertionError(f"features through {what} disagree with the plain path")
    return feats


def flash_bound_ms(kind, b, s, heads) -> tuple:
    """Least time for one attention forward or backward over (b, s, heads,
    64) bf16: the products it needs (forward Q K^T and P V; backward Q K^T
    recomputed, dV, dP, dQ, dK; each 2 S^2 64 per (image, head)) over the
    bf16 peak, vs q, k, v (and dO) read once and o (dq, dk, dv) written
    once. Returns (ms, "operations" | "bytes", flops)."""
    products, tensors = (2, 4) if kind == "fwd" else (5, 7)
    flops = b * heads * products * 2 * s * s * 64
    nbytes = tensors * b * s * heads * 64 * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def library_flash_bwd(q, k, v, do, dtype=None):
    """SDPA's autograd backward on (B, H, S, Dh) copies of q, k, v (in
    `dtype`, default theirs; yardstick only): returns a function that runs
    the backward alone, and the forward's output."""
    leaves = [t.transpose(1, 2).to(dtype or t.dtype).contiguous().requires_grad_(True)
              for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    dot = do.transpose(1, 2).to(dtype or do.dtype).contiguous()
    return (lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)), out.detach()


def check_same_fn_yardstick(q, k, v, do):
    """SDPA on fp32 copies of q, k, v (P and dS in fp32, the Pallas body's
    function, outputs left in fp32): its mean error against float64 beside
    the plain twin's on the same fp32 inputs, so a bf16 P or TF32 inside it
    shows. Returns (forward, backward) functions to time, the copies made
    outside them."""
    from vit2spn_tpu_torch.ops import flash_attention as fa

    copies = [t.transpose(1, 2).float().contiguous() for t in (q, k, v)]
    bwd, out = library_flash_bwd(q, k, v, do, torch.float32)
    got = (out, *bwd())
    ref64 = attention_fp64(q, k, v, do)
    f32 = [t.float() for t in (q, k, v, do)]
    twin = (fa.flash_attention_plain(*f32[:3]), *fa.flash_attention_bwd_plain(*f32))
    errs = [f"{n} {mean_rel64(a.transpose(1, 2), c):.4g}/{mean_rel64(b, c):.4g}"
            for n, a, b, c in zip(("o", "dq", "dk", "dv"), got, twin, ref64)]
    log(f"[library-same-fn] SDPA on fp32 copies, B={q.shape[0]} S={q.shape[1]}: mean error "
        f"vs float64, SDPA / the plain twin on the same fp32 copies: {', '.join(errs)} "
        "(yardstick only; TF32 or a bf16 P would put SDPA far above the twin)")
    return (lambda: F.scaled_dot_product_attention(*copies)), bwd


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
    from vit2spn_tpu_torch.ops import flash_attention as fa
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

    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    cfg = replace(get_preset("ssp"), pretrained_init=False)
    vit = cfg.vit

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all(fb.KERNEL_NAMES)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(fb.KERNEL_NAMES)} in {build_s:.2f} s (in parallel)")
    nt = (vit.seq_len + 15) // 16 * 2  # the attention kernels' key tiles at S
    for name, lib in libs.items():
        for line in ptxas_report(open(f"{lib}.log").read(), nt):
            log(f"[build]   {name}: {line}")
    # the forward layer's kernels take their shared memory at launch
    smem = {k: fb.layer_fwd_smem_bytes(vit.seq_len, vit.hidden_size, k)
            for k in ("ln_qkv", "attention", "mlp")}
    log(f"[build]   layer_fwd / backbone_fwd dynamic shared memory per block at S="
        f"{vit.seq_len}, D={vit.hidden_size}: {smem} B")

    # the fine-tune step's wall time before any other phase (phase 10b times
    # it again after them)
    ft_fresh_s = ft_step_wall_fresh()

    # -- 3. forward kernel vs plain twin at the serving shapes -----------------
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
    # other shapes the kernel takes: ragged M, S < 16 and S = 256, D = 256
    # (the widest layer kept in one block), the ViT-Small and ViT-Base widths
    # (the five-launch layer); 1-2 layers, so the same bounds hold
    for b_, s_, d_, h_, m_, l_ in ((3, 5, 192, 3, 768, 2), (2, 50, 384, 6, 1536, 2),
                                   (1, 256, 192, 3, 768, 1), (5, 17, 768, 12, 3072, 1),
                                   (2, 40, 256, 4, 1024, 1)):
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
    # other shapes: S < 16, S = 17 and 256, a ragged B at S = 197, D = 256
    # (the widest of the wgmma route) and 128 with mlp 320 (its 64-column
    # tiles), and the ViT-Small width (the mma.sync sequence above D = 256);
    # both gelu forms
    for b_, s_, d_, h_, m_, f_ in ((3, 5, 192, 3, 768, True), (2, 17, 192, 3, 768, False),
                                   (1, 256, 192, 3, 768, True), (7, 197, 192, 3, 768, False),
                                   (2, 40, 256, 4, 1024, True), (3, 9, 128, 2, 320, False),
                                   (5, 50, 384, 6, 1536, True)):
        w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d_, m_, dev))
        x_ = torch.randn(b_, s_, d_, generator=gen).to(torch.bfloat16).to(dev)
        g_ = (0.1 * torch.randn(b_, s_, d_, generator=gen)).to(torch.bfloat16).to(dev)
        check_layer_bwd(f"B={b_} S={s_} D={d_} heads={h_} mlp={m_} fast_gelu={f_}", fb, x_,
                        g_, w_, h_, eps, f_, against_fp32=False)
    # two runs of each half at the training shape: the same weight-gradient bits
    runs = [(fb.mlp_bwd(x2_, gb, wl, eps, True), fb.attn_bwd(xb, gb, wl, heads, eps))
            for x2_ in (xb, xb)]
    torch.cuda.synchronize()
    same = all(torch.equal(runs[0][0][1][n], runs[1][0][1][n]) for n in fb.MLP_NAMES) and all(
        torch.equal(runs[0][1][1][n], runs[1][1][1][n]) for n in fb.ATTN_NAMES)
    same_dx = all(torch.equal(runs[0][i][0], runs[1][i][0]) for i in range(2))
    log(f"[determinism] two runs of mlp_bwd and attn_bwd, B={TRAIN_BATCH}: weight gradients "
        f"bitwise equal {same}, dx2 / dx bitwise equal {same_dx}")
    if not (same and same_dx):
        raise AssertionError("the backward halves are not deterministic")
    del runs
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

    # -- 5. the fp32-inside attention kernels vs their plain twins -------------
    flash_err = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for b_, s_, h_, dt in ((TRAIN_BATCH, s, heads, torch.bfloat16),
                           (BATCH, s, heads, torch.bfloat16),
                           (3, 5, 3, torch.bfloat16), (2, 17, 2, torch.bfloat16),
                           (1, 256, 3, torch.bfloat16), (7, s, heads, torch.bfloat16),
                           (4, s, heads, torch.float32), (2, 50, 1, torch.float32)):
        errs = check_flash(f"B={b_} S={s_} H={h_} {str(dt)[6:]}",
                           *flash_operands(gen, b_, s_, h_, dt, dev))
        flash_err = {k: max(v, errs[k]) for k, v in flash_err.items()}
    runs = [fa.flash_bwd(*flash_operands(torch.Generator().manual_seed(SEED), TRAIN_BATCH, s,
                                         heads, torch.bfloat16, dev)) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"[determinism] two flash backward runs, B={TRAIN_BATCH} bf16: dq, dk, dv bitwise "
        f"equal {same}")
    if not all(same):
        raise AssertionError("the flash backward is not deterministic")
    del runs

    # -- 6. the one-layer forward kernel vs its plain twin ---------------------
    layer_err = 0.0
    for b_ in (TRAIN_BATCH, BATCH):
        w0 = tuple(t[0] for t in wt)
        x_ = x[:b_].contiguous()
        for fast in (False, True):
            layer_err = max(layer_err, check_layer_fwd(
                f"B={b_} fast_gelu={fast}", fb, x_, w0, heads, eps, fast))
    for fast in (False, True):
        h = xb
        for l in range(layers):
            h = fb.fused_block(h, tuple(t[l] for t in wt), heads, eps, fast)
        hb = fused_backbone(xb, wt, heads, eps, fast)
        torch.cuda.synchronize()
        share = equal_bits(h, hb)
        log(f"[layer_fwd-vs-backbone] B={TRAIN_BATCH} fast_gelu={fast}: {layers} fused_block "
            f"calls vs one fused_backbone: {100.0 * share:.4f}% of the outputs equal bit "
            f"for bit (must be 100%: one layer code)")
        if share != 1.0:
            raise AssertionError("the per-layer forward differs from the backbone forward")

    # -- 7. the merged layer backward vs the split kernels and its twin -------
    x2b = torch.randn(TRAIN_BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
    merged_err = 0.0
    for fast in (False, True):
        merged_err = max(merged_err, check_merged_bwd(
            f"B={TRAIN_BATCH} fast_gelu={fast}", fb, xb, x2b, gb, wl, heads, eps, fast, True))
    # a ragged B at S = 197, D = 128 with mlp 320 and D = 256 (the kit's
    # route: equal bits required) and the ViT-Small width (the mma.sync
    # sequences: the share reported)
    for b_, s_, d_, h_, m_, f_ in ((7, 197, 192, 3, 768, False), (3, 9, 128, 2, 320, True),
                                   (2, 40, 256, 4, 1024, False), (5, 50, 384, 6, 1536, True)):
        w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d_, m_, dev))
        x_, x2_, g_ = (torch.randn(b_, s_, d_, generator=gen) for _ in range(3))
        x_, x2_, g_ = (t.to(torch.bfloat16).to(dev) for t in (x_, x2_, 0.1 * g_))
        check_merged_bwd(f"B={b_} S={s_} D={d_} heads={h_} mlp={m_} fast_gelu={f_}", fb, x_,
                         x2_, g_, w_, h_, eps, f_, d_ <= fb.HOPPER_BWD_MAX_D)
    # one call's launches: the wrapper's counter, and its CUDA launches
    reset_launches()
    fb.merged_bwd(xb, x2b, gb, wl, heads, eps, True)
    torch.cuda.synchronize()
    counts = read_launches()
    per_call = fb.cuda_launches("merged_bwd", None, d, 0)
    split_calls = fb.cuda_launches("mlp_bwd", None, d, 0) + fb.cuda_launches("attn_bwd", None, d, 0)
    log(f"[merged_bwd] one call at B={TRAIN_BATCH}: merged_bwd counter {counts['merged_bwd']}, "
        f"{per_call} CUDA launches per call (the split pair: {split_calls}; one reduction "
        f"launch for both halves)")
    if counts["merged_bwd"] != 1 or any(n for k, n in counts.items() if k != "merged_bwd"):
        raise AssertionError(f"one merged call launched {counts}")
    if per_call != split_calls - 1:
        raise AssertionError(f"merged_bwd makes {per_call} CUDA launches, not {split_calls - 1}")
    runs = [fb.merged_bwd(xb, x2b, gb, wl, heads, eps, True) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in fb.WEIGHT_NAMES)
    log(f"[determinism] two merged backward runs: weight gradients bitwise equal {same}, "
        f"dx bitwise equal {torch.equal(runs[0][0], runs[1][0])}")
    if not same:
        raise AssertionError("the merged backward is not deterministic")
    del runs

    # -- 7b. the fp32 routes (compute_dtype=float32) vs their fp32 twins -------
    fp32_err = check_fp32_layer(f"B={TRAIN_BATCH} S={s} D={d}", fb, xb.float(), x2b.float(),
                                gb.float(), wl, heads, eps, True)
    w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, 384, 1536, dev))
    x_, x2_, g_ = (torch.randn(3, 17, 384, generator=gen).to(dev) for _ in range(3))
    for k, v in check_fp32_layer("B=3 S=17 D=384 heads=6 mlp=1536", fb, x_, x2_, 0.1 * g_,
                                 w_, 6, eps, False).items():
        fp32_err[k] = max(fp32_err[k], v)
    wt64 = tuple(t.double() for t in wt32)
    x32 = x.float()
    for emit in (False, True):
        got = fused_backbone(x32, wt32, heads, eps, fast, emit)
        torch.cuda.synchronize()
        ref = backbone_forward_plain(x32, wt32, heads, eps, fast, emit)
        ref64 = backbone_forward_plain(x32.double(), wt64, heads, eps, fast, emit)
        got, ref, ref64 = ((t,) if not emit else t for t in (got, ref, ref64))
        fp32_err["backbone_fwd"] = check_fp32_outputs(
            "backbone_fwd-fp32", f"B={BATCH} L={layers} emit_res={emit}",
            ("out", "xs", "x2s"), got, ref, ref64, FP32_TOL_12)
    del ref64
    # the 12-layer backward through the Function, fp32, against the twin's
    b12 = 32
    xg = x32[:b12].clone().requires_grad_(True)
    wg = tuple(t.clone().requires_grad_(True) for t in wt32)
    out = fused_backbone(xg, wg, heads, eps, fast)
    g12 = 0.1 * torch.randn(out.shape, generator=gen).to(dev)
    dx12, *dw12 = torch.autograd.grad(out, (xg, *wg), g12)
    torch.cuda.synchronize()
    _, xs12, x2s12 = backbone_forward_plain(x32[:b12], wt32, heads, eps, fast, True)
    rdx, rdw = fb.backbone_backward_plain(xs12, x2s12, g12, wt32, heads, eps, fast)
    _, xs64, x2s64 = backbone_forward_plain(x32[:b12].double(), wt64, heads, eps, fast, True)
    rdx64, rdw64 = fb.backbone_backward_plain(xs64, x2s64, g12.double(), wt64, heads, eps, fast)
    check_fp32_outputs("backward-12-layers-fp32", f"B={b12} L={layers}",
                       ("dx",) + fb.WEIGHT_NAMES, [dx12, *dw12], [rdx, *rdw],
                       [rdx64, *rdw64], FP32_TOL_12)
    del xg, wg, dw12, xs12, x2s12, xs64, x2s64, rdw, rdw64
    # a refused launch raises: the C entry point rejects M = 0 (no twin runs)
    lib = fb._load("mlp_bwd")
    rc = lib.vit2spn_mlp_bwd(*[None] * 19, 0, d, mlp, eps, 1, 1, None)
    try:
        fb._raise_on(lib, rc, "mlp backward")
        raise AssertionError("a refused fp32 launch did not raise")
    except RuntimeError as e:
        log(f"[fp32] a refused launch raises: {e}")

    # -- 8. the serving path end to end, through each backbone path -----------
    ds = synthetic_dataset(split_sizes={"all": N_IMAGES}, image_size=28, seed=SEED)
    quiet = MetricLogger(echo=False)
    trainer = SSPTrainer(cfg, logger=quiet, device="cuda")
    trainer.extract_features(ds, batch_size=BATCH)  # warm-up (allocator, build)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats, labels = trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    extract_launches = read_launches()
    log(f"[extract] {feats.shape} features, {extract_launches[KERNEL_NAME]} backbone kernel "
        f"launches ({extract_launches[KERNEL_NAME] * layers * kernel_launches_per_layer(d)} "
        f"CUDA kernel launches), {extract_s:.3f} s, {N_IMAGES / extract_s:.1f} img/s")
    if extract_launches[KERNEL_NAME] <= 0:
        raise AssertionError("the serving path never launched the backbone kernel")
    if any(n for k, n in extract_launches.items() if k != KERNEL_NAME):
        raise AssertionError(f"the serving path launched another kernel: {extract_launches}")
    if feats.shape != (N_IMAGES, cfg.proj_dim) or not np.isfinite(feats).all():
        raise AssertionError(f"bad features: shape {feats.shape}, "
                             f"finite {np.isfinite(feats).all()}")
    if labels.shape != (N_IMAGES,):
        raise AssertionError(f"bad labels shape {labels.shape}")
    trainer.attn_impl = "plain"
    feats_plain, _ = trainer.extract_features(ds, batch_size=BATCH)
    scale = float(np.abs(feats_plain).max())
    feat_err = float(np.abs(feats - feats_plain).max())
    log(f"[extract-vs-plain] max_abs_err {feat_err:.6g} (max |plain| {scale:.4g}, "
        f"tol {FEATURE_REL_TOL} relative)")
    if not feat_err <= FEATURE_REL_TOL * scale:
        raise AssertionError("served features disagree with the plain path")
    extract_path(trainer, ds, "pallas", feats_plain, ("flash_fwd",))
    extract_path(trainer, ds, "fused_layer", feats_plain, ("layer_fwd",))
    del trainer

    # -- 8b. serving under compute_dtype=float32, through the fp32 kernels -----
    cfg32 = replace(cfg, compute_dtype="float32")
    trainer32 = SSPTrainer(cfg32, logger=quiet, device="cuda")
    trainer32.attn_impl = "plain"
    feats32_plain, _ = trainer32.extract_features(ds, batch_size=BATCH)
    extract_path(trainer32, ds, "fused", feats32_plain, (KERNEL_NAME,),
                 tol=FP32_FEATURE_REL_TOL, what="fused fp32")
    del trainer32

    # -- 9. the training path end to end ---------------------------------------
    tcfg = replace(cfg, batch_size=TRAIN_BATCH)
    eff = tcfg.effective_batch
    a = tcfg.accumulation_steps
    tds = synthetic_dataset(split_sizes={"train": TRAIN_IMAGES}, image_size=28,
                            seed=SEED).split("train")
    step_check(tcfg, tds.images[:eff], tcfg.learning_rate)
    torch.cuda.empty_cache()
    # per optimizer step: 2 streams x (online under grad + target) backbone
    # forwards per microbatch, 2 online backwards of every layer
    split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers}
    trainer, train_launches, _ = fit_path(tcfg, tds, "fused", False,
                                          {KERNEL_NAME: 2 * 2 * a, **split})

    # -- 9b. training under compute_dtype=float32 through the fp32 kernels -----
    # step 1 of "fused" against "plain" from the same state, then one step of
    # each fused path with the counters read around it
    tcfg32 = replace(tcfg, compute_dtype="float32")
    fds = synthetic_dataset(split_sizes={"train": FP32_IMAGES}, image_size=28,
                            seed=SEED + 2).split("train")
    step_check(tcfg32, fds.images[:eff], tcfg32.learning_rate)
    torch.cuda.empty_cache()
    fp32_launches = {}
    for impl, merged, per_step in (
            ("fused", False, {KERNEL_NAME: 2 * 2 * a, **split}),
            ("fused_layer", False, {"layer_fwd": 2 * 2 * a * layers, **split}),
            ("fused", True, {KERNEL_NAME: 2 * 2 * a, "merged_bwd": 2 * a * layers})):
        t32, launches32, _ = fit_path(tcfg32, fds, impl, merged, per_step)
        fp32_launches.update({k: n for k, n in launches32.items() if n})
        del t32
        torch.cuda.empty_cache()
    os.environ["VIT2SPN_MERGED_BWD"] = "0"

    # -- 9c. the pretrained init from a local weight file -----------------------
    check_pretrained_init(cfg, dev)

    # -- 10. the other backbone paths end to end -------------------------------
    pds = synthetic_dataset(split_sizes={"train": PATH_IMAGES}, image_size=28,
                            seed=SEED + 1).split("train")
    per_layer_fwd = 2 * 2 * a * layers
    paths = (
        # (attn_impl, merged backward, its reference path, launches per step)
        ("pallas", False, ("xla", False),
         {"flash_fwd": per_layer_fwd, "flash_bwd": 2 * a * layers}),
        ("fused_layer", False, ("fused", False), {"layer_fwd": per_layer_fwd, **split}),
        ("fused", True, ("fused", False),
         {KERNEL_NAME: 2 * 2 * a, "merged_bwd": 2 * a * layers}),
    )
    path_launches, step_ms = {}, {}
    rest = "views, embed, heads, loss, Adam, EMA"
    for impl, merged, ref_path, per_step in paths:
        step_check(tcfg, pds.images[:eff], tcfg.learning_rate, (impl, merged), ref_path)
        torch.cuda.empty_cache()
        ptrainer, launches, _ = fit_path(tcfg, pds, impl, merged, per_step)
        path_launches.update({k: n for k, n in launches.items() if n})
        name = f"{impl}{' merged' if merged else ''}"
        if merged:  # the merged step's backward launches against the split step's
            calls = per_step["merged_bwd"]
            log(f"[train] {name}: {calls} merged_bwd calls per step x "
                f"{fb.cuda_launches('merged_bwd', None, d, 0)} CUDA launches; the split step's "
                f"{calls} x ({fb.cuda_launches('mlp_bwd', None, d, 0)} + "
                f"{fb.cuda_launches('attn_bwd', None, d, 0)})")
        step_ms[name] = 1e3 * time_steps(
            ptrainer, eff, name, card, tuple(per_step),
            ("the per-op blocks' LayerNorms, GEMMs and gelu, " + rest) if impl == "pallas"
            else rest)
        os.environ["VIT2SPN_MERGED_BWD"] = "0"
        del ptrainer
        torch.cuda.empty_cache()

    # -- 10b. the fine-tune path end to end ----------------------------------------
    ft_launches = finetune_path(trainer, card, ft_fresh_s)

    # -- 12. the folder datasets and the parity runbook end to end ------------------
    folder_launches = folder_path(trainer, card)

    # -- 11. times ---------------------------------------------------------------
    fast = fast_gelu_default()
    kernel_ms = time_ms(lambda: fused_backbone(x, wt, heads, eps, fast))
    plain_ms = time_ms(lambda: backbone_forward_plain(x, wt, heads, eps, fast),
                       iters=5, warmup=1)
    with torch.no_grad():
        library_ms = time_ms(lambda: library_backbone(x, wt, heads, eps))
    bound_ms, bound_by, flops = backbone_bound_ms(BATCH, s, d, heads, mlp,
                                                  layers, wt)
    log(f"[time] backbone forward B={BATCH}: kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / (layers * kernel_launches_per_layer(d)):.4f} ms per CUDA "
        f"launch, {layers * kernel_launches_per_layer(d)} launches), plain twin "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP), kernel at "
        f"{flops / (kernel_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    # by stage, the kernel's and the library yardstick's, one after the other
    for line in stage_breakdown(lambda: fused_backbone(x, wt, heads, eps, fast),
                                "kernel: one backbone forward"):
        log(line)
    with torch.no_grad():
        for line in stage_breakdown(lambda: library_backbone(x, wt, heads, eps),
                                    "library yardstick: one backbone forward"):
            log(line)
    entries = [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "vit2spn_tpu_torch/csrc/backbone_fwd.cu",
        "replaces": "vit2spn_tpu/ops/fused_block.py:694",
        "launches": train_launches[KERNEL_NAME],
        "finetune_launches": ft_launches.get(KERNEL_NAME, 0),
        "folder_launches": folder_launches.get(KERNEL_NAME, 0), "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "library_same_fn_ms": None,
        "dtype": "bfloat16",
    }]
    # the new kernels at their paths' shapes: B=128, bf16
    q, k, v, do = flash_operands(gen, TRAIN_BATCH, s, heads, torch.bfloat16, dev)
    w0 = tuple(t[0] for t in wt)
    same_fn = check_same_fn_yardstick(q, k, v, do)
    merged_lib = (lambda: library_attn_half(
        xb, library_mlp_half(x2b, gb, wl, eps)[0].to(xb.dtype), wl, heads, eps))
    timed = (
        # name, source, replaces, (ms, "operations" | "bytes", flops), CUDA launches,
        # max_abs_err, kernel, plain twin, library yardstick (never called by the port)
        # and, where the library call keeps P and dS in fp32, that one
        ("mlp_bwd", "mlp_bwd.cu", "vit2spn_tpu/ops/fused_block.py:342",
         bwd_bound_ms("mlp", TRAIN_BATCH, s, d, heads, mlp, wl),
         fb.cuda_launches("mlp_bwd", None, d, 0), bwd_err["mlp_bwd"],
         lambda: fb.mlp_bwd(xb, gb, wl, eps, fast),
         lambda: fb.mlp_bwd_plain(xb, gb, wl, eps, fast),
         lambda: library_mlp_half(xb, gb, wl, eps), None),
        ("attn_bwd", "attn_bwd.cu", "vit2spn_tpu/ops/fused_block.py:357",
         bwd_bound_ms("attn", TRAIN_BATCH, s, d, heads, mlp, wl),
         fb.cuda_launches("attn_bwd", None, d, 0), bwd_err["attn_bwd"],
         lambda: fb.attn_bwd(xb, gb, wl, heads, eps),
         lambda: fb.attn_bwd_plain(xb, gb, wl, heads, eps),
         lambda: library_attn_half(xb, gb, wl, heads, eps), None),
        ("merged_bwd", "merged_bwd.cu", "vit2spn_tpu/ops/fused_block.py:375",
         bwd_bound_ms("merged", TRAIN_BATCH, s, d, heads, mlp, wl),
         fb.cuda_launches("merged_bwd", None, d, 0), merged_err,
         lambda: fb.merged_bwd(xb, x2b, gb, wl, heads, eps, fast),
         lambda: fb.merged_bwd_plain(xb, x2b, gb, wl, heads, eps, fast), merged_lib, None),
        ("layer_fwd", "layer_fwd.cu", "vit2spn_tpu/ops/fused_block.py:170",
         backbone_bound_ms(TRAIN_BATCH, s, d, heads, mlp, 1, w0, acts=3),
         fb.cuda_launches("layer_fwd", None, d, 0), layer_err,
         lambda: fb.layer_fwd(xb, w0, heads, eps, fast),
         lambda: fb.layer_forward_plain(xb, w0, heads, eps, fast),
         lambda: library_backbone(xb, tuple(t[:1] for t in wt), heads, eps), None),
        ("flash_fwd", "flash_attention.cu", "vit2spn_tpu/ops/flash_attention.py:36",
         flash_bound_ms("fwd", TRAIN_BATCH, s, heads), fb.cuda_launches("flash_fwd", fa.KERNEL_NAME),
         flash_err["flash_fwd"], lambda: fa.flash_fwd(q, k, v),
         lambda: fa.flash_attention_plain(q, k, v),
         lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v))),
         same_fn[0]),
        ("flash_bwd", "flash_attention.cu", "vit2spn_tpu/ops/flash_attention.py:53",
         flash_bound_ms("bwd", TRAIN_BATCH, s, heads), fb.cuda_launches("flash_bwd", fa.KERNEL_NAME),
         flash_err["flash_bwd"], lambda: fa.flash_bwd(q, k, v, do),
         lambda: fa.flash_attention_bwd_plain(q, k, v, do),
         library_flash_bwd(q, k, v, do)[0], same_fn[1]),
    )
    # the fp32 routes (compute_dtype=float32) at the same shapes, the backbone
    # at B=256; their launches are the fp32 training steps' (phase 9b)
    x32, xb32, x2b32, gb32 = x.float(), xb.float(), x2b.float(), gb.float()
    wl32 = {n: t.float() for n, t in wl.items()}
    w032 = tuple(t.float() for t in w0)
    timed += (
        ("backbone_fwd (fp32)", "backbone_fwd.cu", "vit2spn_tpu/ops/fused_block.py:694",
         backbone_bound_ms(BATCH, s, d, heads, mlp, layers, wt32),
         layers * kernel_launches_per_layer(d, True), fp32_err["backbone_fwd"],
         lambda: fused_backbone(x32, wt32, heads, eps, fast),
         lambda: backbone_forward_plain(x32, wt32, heads, eps, fast),
         lambda: library_backbone(x32, wt32, heads, eps), None),
        ("mlp_bwd (fp32)", "mlp_bwd.cu", "vit2spn_tpu/ops/fused_block.py:342",
         bwd_bound_ms("mlp", TRAIN_BATCH, s, d, heads, mlp, wl32),
         fb.cuda_launches("mlp_bwd", None, d, 1), fp32_err["mlp_bwd"],
         lambda: fb.mlp_bwd(xb32, gb32, wl32, eps, fast),
         lambda: fb.mlp_bwd_plain(xb32, gb32, wl32, eps, fast),
         lambda: library_mlp_half(xb32, gb32, wl32, eps), None),
        ("attn_bwd (fp32)", "attn_bwd.cu", "vit2spn_tpu/ops/fused_block.py:357",
         bwd_bound_ms("attn", TRAIN_BATCH, s, d, heads, mlp, wl32),
         fb.cuda_launches("attn_bwd", None, d, 1), fp32_err["attn_bwd"],
         lambda: fb.attn_bwd(xb32, gb32, wl32, heads, eps),
         lambda: fb.attn_bwd_plain(xb32, gb32, wl32, heads, eps),
         lambda: library_attn_half(xb32, gb32, wl32, heads, eps), None),
        ("merged_bwd (fp32)", "merged_bwd.cu", "vit2spn_tpu/ops/fused_block.py:375",
         bwd_bound_ms("merged", TRAIN_BATCH, s, d, heads, mlp, wl32),
         fb.cuda_launches("merged_bwd", None, d, 1), fp32_err["merged_bwd"],
         lambda: fb.merged_bwd(xb32, x2b32, gb32, wl32, heads, eps, fast),
         lambda: fb.merged_bwd_plain(xb32, x2b32, gb32, wl32, heads, eps, fast),
         lambda: library_attn_half(xb32, library_mlp_half(x2b32, gb32, wl32, eps)[0], wl32,
                                   heads, eps), None),
        ("layer_fwd (fp32)", "layer_fwd.cu", "vit2spn_tpu/ops/fused_block.py:170",
         backbone_bound_ms(TRAIN_BATCH, s, d, heads, mlp, 1, w032, acts=3),
         fb.cuda_launches("layer_fwd", None, d, 1), fp32_err["layer_fwd"],
         lambda: fb.layer_fwd(xb32, w032, heads, eps, fast),
         lambda: fb.layer_forward_plain(xb32, w032, heads, eps, fast),
         lambda: library_backbone(xb32, tuple(t[:1] for t in wt32), heads, eps), None),
    )
    # mlp_bwd / attn_bwd: their counts on the "fused" path, as before; the
    # fp32 routes' on the fp32 paths
    launches = {**path_launches, **{k: n for k, n in train_launches.items() if n},
                **{f"{k} (fp32)": n for k, n in fp32_launches.items()}}
    for name, src, replaces, bound, n_cuda, err, kernel, twin, library, same in timed:
        b_ms, b_by, b_flops = bound
        k_ms = time_ms(kernel)
        p_ms = time_ms(twin, iters=5, warmup=1)
        forward = name.split()[0] in ("layer_fwd", "flash_fwd", KERNEL_NAME)
        with torch.no_grad() if forward else torch.enable_grad():
            l_ms = time_ms(library)
            s_ms = time_ms(same) if same else None
        batch = BATCH if name.startswith(KERNEL_NAME) else TRAIN_BATCH
        log(f"[time] {name} B={batch}: kernel {k_ms:.4f} ms ({n_cuda} CUDA launches), "
            f"plain twin {p_ms:.3f} ms, library {l_ms:.4f} ms"
            + (f" (fp32, the same function: {s_ms:.4f} ms)" if same else "")
            + f", bound {b_ms:.4f} ms ({b_by}; {b_flops / 1e9:.2f} GFLOP), kernel at "
            f"{b_flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the bound")
        entries.append({
            "name": name, "route": "cuda", "source": f"vit2spn_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "finetune_launches": ft_launches.get(name, 0),
            "folder_launches": folder_launches.get(name, 0), "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "library_same_fn_ms": s_ms,
            "dtype": "float32" if name.endswith("(fp32)") else "bfloat16",
        })
    # the backward kernels by stage (CUDA kernel), B=128, bf16 and fp32,
    # over STAGE_CALLS calls (the trace drops a call's first few launches)
    for name, fn in (("mlp_bwd", lambda: fb.mlp_bwd(xb, gb, wl, eps, fast)),
                     ("attn_bwd", lambda: fb.attn_bwd(xb, gb, wl, heads, eps)),
                     ("merged_bwd", lambda: fb.merged_bwd(xb, x2b, gb, wl, heads, eps, fast)),
                     ("mlp_bwd (fp32)", lambda: fb.mlp_bwd(xb32, gb32, wl32, eps, fast)),
                     ("attn_bwd (fp32)", lambda: fb.attn_bwd(xb32, gb32, wl32, heads, eps))):
        for line in stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)],
                                    f"{name} B={TRAIN_BATCH} by stage, {STAGE_CALLS} calls",
                                    top=10):
            log(line)
    time_gemm_f32(fb, TRAIN_BATCH * s, d, mlp, gen, dev)

    trainer_s = SSPTrainer(cfg, logger=quiet, device="cuda")
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

    step_ms["fused"] = 1e3 * time_steps(trainer, eff, "fused", card,
                                        (KERNEL_NAME, "mlp_bwd", "attn_bwd"), rest)
    log(f"[time] optimizer step by backbone path, ms: {json.dumps(step_ms)}")

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
