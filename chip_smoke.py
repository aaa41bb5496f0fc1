#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit2spn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel of the serving path from csrc/, with seconds
     and the compiler's register / shared-memory report;
  3. every kernel against its plain PyTorch twin on the card, at the shapes
     the serving path gives it (ViT-Tiny: L=12, D=192, 3 heads, mlp 768,
     S=197, B=256, bf16), both gelu forms and both emit_res settings, and at
     a few other shapes it takes (ragged batches, short and 256-token
     sequences, the ViT-Small and ViT-Base widths);
  4. the serving path end to end: SSPTrainer on the dual-stream `ssp` preset
     (random init from the seed) runs extract_features over 1024 synthetic
     28 px images at batch 256. The kernels' launch counters are set to 0
     just before and read just after; the features must be finite, (1024,
     128), and agree with the same path run through the plain twin;
  5. times with CUDA events after a warm-up: the kernel, its plain twin and
     a library yardstick (F.layer_norm / torch.matmul / SDPA / F.gelu) per
     backbone forward at B=256, the least time the card could take for the
     same work, end-to-end extract images/s, and the kernel's device time by
     stage from torch.profiler.

The line before the last is one JSON object {"kernels": [...]} with each
kernel's numbers; the last line is {"ok": true, "device": {...}}. The
script needs no network and no JAX, and stops every process it starts.
"""

from __future__ import annotations

import json
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


def stage_breakdown(fn) -> list:
    """Device time by CUDA kernel name over one call of `fn`, from
    torch.profiler (CUPTI); says so when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.count and ev.key.startswith(("_Z", "void", "gemm", "attention")):
            rows.append((dev_us, ev.count, ev.key))
    if not rows:
        return ["[profile] the trace holds no device time: not measured"]
    total = sum(r[0] for r in rows)
    out = [f"[profile] one backbone forward: {total / 1e3:.3f} ms device time "
           f"in {sum(r[1] for r in rows)} kernel launches"]
    for us, n, key in sorted(rows, reverse=True):
        out.append(f"[profile]   {us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
                   f"x{n:<3d} {key[:90]}")
    return out


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
    libs = cuda_build.build_all([KERNEL_NAME])
    build_s = time.perf_counter() - t0
    log(f"[build] {KERNEL_NAME} in {build_s:.2f} s -> {libs[KERNEL_NAME].name}")
    for line in open(f"{libs[KERNEL_NAME]}.log"):
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # -- 3. kernel vs plain twin at the serving shapes -------------------------
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

    # -- 4. the serving path end to end --------------------------------------
    ds = synthetic_dataset(split_sizes={"all": N_IMAGES}, image_size=28, seed=SEED)
    quiet = MetricLogger(echo=False)
    trainer = SSPTrainer(cfg, logger=quiet, device="cuda")
    trainer.extract_features(ds, batch_size=BATCH)  # warm-up (allocator, build)
    torch.cuda.synchronize()
    fused_backbone.launches = 0
    t0 = time.perf_counter()
    feats, labels = trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = fused_backbone.launches
    log(f"[extract] {feats.shape} features, {launches} backbone kernel "
        f"launches ({launches * layers * kernel_launches_per_layer()} CUDA "
        f"kernel launches), {extract_s:.3f} s, {N_IMAGES / extract_s:.1f} img/s")
    if launches <= 0:
        raise AssertionError("the serving path never launched the backbone kernel")
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

    # -- 5. times ---------------------------------------------------------------
    fast = fast_gelu_default()
    kernel_ms = time_ms(lambda: fused_backbone(x, wt, heads, eps, fast))
    plain_ms = time_ms(lambda: backbone_forward_plain(x, wt, heads, eps, fast),
                       iters=5, warmup=1)
    with torch.no_grad():
        library_ms = time_ms(lambda: library_backbone(x, wt, heads, eps))
    bound_ms, bound_by, flops = backbone_bound_ms(BATCH, s, d, heads, mlp,
                                                  layers, wt)
    fused_backbone.launches = 0  # timing launches are not the serving path's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    e2e = reps * N_IMAGES / (time.perf_counter() - t0)
    log(f"[time] backbone forward B={BATCH}: kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / (layers * kernel_launches_per_layer()):.4f} ms per CUDA "
        f"launch, {layers * kernel_launches_per_layer()} launches), plain twin "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP), kernel at "
        f"{flops / (kernel_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    log(f"[time] extract end to end (dual stream, pred): {e2e:.1f} img/s "
        f"over {reps} x {N_IMAGES} images on {card}")

    for line in stage_breakdown(lambda: fused_backbone(x, wt, heads, eps, fast)):
        log(line)

    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME,
        "route": "cuda",
        "source": "vit2spn_tpu_torch/csrc/backbone_fwd.cu",
        "replaces": "vit2spn_tpu/ops/fused_block.py:694",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
