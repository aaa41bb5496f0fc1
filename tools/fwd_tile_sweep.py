#!/usr/bin/env python3
"""Time the forward layer kernels of the PyTorch port
(vit2spn_tpu_torch/csrc/layer_fwd.cuh, run by backbone_fwd.cu and
layer_fwd.cu) at other block geometries, on one CUDA card:

    python tools/fwd_tile_sweep.py [--seq 197] [--layers 12]

For each (ATT_WG, ATT_STAGES, ATT_PERSIST, ATT_DIV, QKV_WG, GEMM_RING)
geometry below both sources are compiled with those macros (the attention
kernel's 64-query warpgroups per block, its stages of {Q, K, V} per block,
persistent blocks walking (image, head) items or one block per item, and
its quotient p / sum: 2 the division's fast path where it is exact, 0 the
IEEE division throughout; 64-row warpgroups per LN1 + QKV block; weight
stages in flight in the row-block GEMM) into build/fwd_sweep/, all builds
started together; the wrappers then
run each geometry's libraries on the same ViT-Tiny weights and inputs:
`fused_backbone` at B=256 and `layer_fwd` at B=128, timed with CUDA events
after a warm-up, and torch.profiler's device time per kernel of the
backbone. Every geometry does the same arithmetic per row and per query
(both quotients round as the IEEE division), so its outputs must equal the
first geometry's bit for bit. Prints the card,
and per geometry the compiler's registers and spills of the forward's
kernels, both times, the attention kernel's device time per backbone
forward and the per-kernel breakdown.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    attention_stage_ms,
    card_line,
    ptxas_report,
    random_backbone,
    stage_breakdown,
    time_ms,
)
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops import fused_block as fb  # noqa: E402

# (ATT_WG, ATT_STAGES, ATT_PERSIST, ATT_DIV, QKV_WG, GEMM_RING); the first
# is the kept geometry
GEOMETRIES = ((2, 2, 1, 2, 2, 4), (2, 2, 1, 0, 2, 4), (1, 1, 1, 2, 2, 4), (1, 2, 1, 2, 2, 4),
              (2, 1, 0, 2, 2, 4))
KNOBS = ("ATT_WG", "ATT_STAGES", "ATT_PERSIST", "ATT_DIV", "QKV_WG", "GEMM_RING")
OUT = cuda_build.BUILD_DIR.parent / "fwd_sweep"
SOURCES = ("backbone_fwd", "layer_fwd")


def build(geoms):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for g in geoms:
        flags = [f"-D{k}={v}" for k, v in zip(KNOBS, g)]
        for src in SOURCES:
            so = OUT / f"{src}_{'_'.join(map(str, g))}.so"
            cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(so),
                   str(cuda_build.CSRC / f"{src}.cu")]
            procs[(g, src)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (g, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {g} {src}:\n{log[-4000:]}")
        libs.setdefault(g, {})[src] = (ctypes.CDLL(str(so)), log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--layers", type=int, default=12)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("fwd_tile_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    libs = build(GEOMETRIES)
    d, heads, mlp, eps, fast = 192, 3, 768, 1e-12, True
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    wt = random_backbone(gen, a.layers, d, mlp, dev)
    w0 = tuple(t[0] for t in wt)
    x = torch.randn(256, a.seq, d, generator=gen).to(torch.bfloat16).to(dev)
    xl = x[:128].contiguous()
    nt = (a.seq + 15) // 16 * 2
    ref = None
    for g, by_src in libs.items():
        # the wrappers load their libraries through cuda_build's cache: point
        # it at this geometry's builds
        for src, (lib, _) in by_src.items():
            cuda_build._LIBS[src] = lib
        outs = (fb.fused_backbone(x, wt, heads, eps, fast), *fb.layer_fwd(xl, w0, heads, eps, fast))
        torch.cuda.synchronize()
        ref = ref or outs
        same = all(torch.equal(p, q) for p, q in zip(outs, ref))
        bb_ms = time_ms(lambda: fb.fused_backbone(x, wt, heads, eps, fast), iters=10)
        ly_ms = time_ms(lambda: fb.layer_fwd(xl, w0, heads, eps, fast, emit_x2=False), iters=50)
        regs = [r for r in ptxas_report(by_src["backbone_fwd"][1], nt)
                if r.startswith(("attention", "rowblock_gemm_kernel<2,192", "mlp_block_kernel<192"))]
        totals = {}
        lines = stage_breakdown(lambda: fb.fused_backbone(x, wt, heads, eps, fast), top=4,
                                totals=totals)
        att_ms, att_n = attention_stage_ms(totals)
        print(f"[sweep] {' '.join(f'{k} {v}' for k, v in zip(KNOBS, g))}: backbone_fwd B=256 "
              f"{bb_ms:.4f} ms (attention stage {att_ms:.4f} ms device, {att_n} launches), "
              f"layer_fwd B=128 {ly_ms:.4f} ms; bits equal to the first geometry: {same}; "
              f"{'; '.join(regs)}")
        for line in lines:
            print(f"[sweep]   {line}")
        if not same:
            return 1
    print(f"[sweep] ViT-Tiny L={a.layers} S={a.seq} bf16 on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
