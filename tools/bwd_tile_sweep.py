#!/usr/bin/env python3
"""Time the backward halves of the PyTorch port (vit2spn_tpu_torch/csrc/
mlp_bwd.cu and attn_bwd.cu) by stage at other block geometries, on one CUDA
card:

    python tools/bwd_tile_sweep.py [--batch 128] [--seq 197] [--parent DIR]

For each (AB_WARPS, GEMM_RING) pair below both sources are compiled with
those macros (warps per (image, head) block of the attention-backward core;
weight stages in flight in the row-block GEMMs) into build/bwd_sweep/, all
builds started together; the wrappers then run each geometry's libraries on
the same ViT-Tiny layer weights and inputs (bf16): `mlp_bwd` and `attn_bwd`
timed with CUDA events after a warm-up, and torch.profiler's device time
per kernel (stage) of each. Every geometry does the same arithmetic per row,
query and key, so its outputs (dx and the weight gradients) must equal the
first geometry's bit for bit.

With --parent DIR (an unpacked checkout of an earlier commit, e.g. the
parent of a change), that tree's mlp_bwd.cu and attn_bwd.cu are built too
and timed the same way, before and after the geometries, through their C
entry points as the port had them before the fp32 route (no dtype flag):
the before / after of a change in one call, on one card.

Prints the card, per geometry the compiler's registers and spills of the
halves' kernels, both times and the per-stage breakdowns.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, ptxas_report, random_backbone, stage_breakdown, time_ms  # noqa: E402
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops import fused_block as fb  # noqa: E402

# (AB_WARPS, GEMM_RING); the first is the kept geometry
GEOMETRIES = ((16, 4), (8, 4), (4, 4), (16, 2))
OUT = cuda_build.BUILD_DIR.parent / "bwd_sweep"
SOURCES = ("mlp_bwd", "attn_bwd")
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _compile(jobs):
    """{key: (csrc dir, source, flags, output)} -> {key: (CDLL, log)}, all
    nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (csrc, src, flags, so) in jobs.items():
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(so),
               str(csrc / f"{src}.cu")]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        libs[key] = (ctypes.CDLL(str(so)), log)
    return libs


def _parent_halves(lib_mlp, lib_attn, x, dy, w, heads, eps):
    """The two halves through an earlier tree's C entry points (bf16, no
    dtype flag): returns a function running both once, with its outputs."""
    for fn, args in ((lib_mlp.vit2spn_mlp_bwd, [_P] * 19 + [_I] * 3 + [_F, _I, _P]),
                     (lib_attn.vit2spn_attn_bwd, [_P] * 21 + [_I] * 4 + [_F, _P])):
        fn.argtypes, fn.restype = args, _I
    lib_mlp.vit2spn_mlp_bwd_workspace_floats.argtypes = [_I] * 3
    lib_mlp.vit2spn_mlp_bwd_workspace_floats.restype = _LL
    lib_attn.vit2spn_attn_bwd_workspace_floats.argtypes = [_I] * 2
    lib_attn.vit2spn_attn_bwd_workspace_floats.restype = _LL
    b, s, d = x.shape
    m, mlp = b * s, w["w1"].shape[1]

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=x.device)

    grads = {n: t(*w[n].shape, dtype=torch.float32) for n in fb.WEIGHT_NAMES}
    dx2, dx = torch.empty_like(x), torch.empty_like(x)
    mlp_scr = (t(m, d), t(m, mlp), t(m, mlp), t(m, d, dtype=torch.float32),
               t(lib_mlp.vit2spn_mlp_bwd_workspace_floats(m, d, mlp), dtype=torch.float32))
    attn_scr = (t(m, d), t(m, 3 * d), t(m, d), t(m, d), t(m, 3 * d),
                t(m, d, dtype=torch.float32),
                t(lib_attn.vit2spn_attn_bwd_workspace_floats(m, d), dtype=torch.float32))
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib_mlp.vit2spn_mlp_bwd(
            x.data_ptr(), dy.data_ptr(), *[w[n].data_ptr() for n in fb.MLP_NAMES[:5]],
            dx2.data_ptr(), *[grads[n].data_ptr() for n in fb.MLP_NAMES],
            *[u.data_ptr() for u in mlp_scr], m, d, mlp, float(eps), 1, stream)
        rc |= lib_attn.vit2spn_attn_bwd(
            x.data_ptr(), dx2.data_ptr(), *[w[n].data_ptr() for n in fb.ATTN_NAMES[:5]],
            dx.data_ptr(), *[grads[n].data_ptr() for n in fb.ATTN_NAMES],
            *[u.data_ptr() for u in attn_scr], b, s, d, heads, float(eps), stream)
        if rc:
            raise RuntimeError(f"parent kernels failed ({rc})")
        return dx, grads

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked earlier checkout whose halves to time as well")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_tile_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    jobs = {}
    for g in GEOMETRIES:
        for src in SOURCES:
            jobs[(g, src)] = (cuda_build.CSRC, src, [f"-DAB_WARPS={g[0]}", f"-DGEMM_RING={g[1]}"],
                              OUT / f"{src}_w{g[0]}_r{g[1]}.so")
    if a.parent:
        for src in SOURCES:
            jobs[("parent", src)] = (a.parent / "vit2spn_tpu_torch" / "csrc", src, [],
                                     OUT / f"{src}_parent.so")
    libs = _compile(jobs)
    d, heads, mlp, eps = 192, 3, 768, 1e-12
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    w = {n: t[0] for n, t in zip(fb.WEIGHT_NAMES, random_backbone(gen, 1, d, mlp, dev))}
    x = torch.randn(a.batch, a.seq, d, generator=gen).to(torch.bfloat16).to(dev)
    dy = (0.1 * torch.randn(a.batch, a.seq, d, generator=gen)).to(torch.bfloat16).to(dev)
    nt = (a.seq + 15) // 16 * 2

    def parent_run(when):
        pr = _parent_halves(libs[("parent", "mlp_bwd")][0], libs[("parent", "attn_bwd")][0],
                            x, dy, w, heads, eps)
        pr()
        ms = time_ms(pr, iters=30)
        print(f"[sweep] parent ({when}): mlp_bwd + attn_bwd B={a.batch} {ms:.4f} ms")
        for line in stage_breakdown(pr, "parent: both halves", top=16):
            print(f"[sweep]   {line}")

    if a.parent:
        parent_run("first")
    ref = None
    for g in GEOMETRIES:
        # the wrappers load their libraries through cuda_build's cache: point
        # it at this geometry's builds
        for src in SOURCES:
            cuda_build._LIBS[src] = libs[(g, src)][0]
        dx2, g_mlp = fb.mlp_bwd(x, dy, w, eps, True)
        dx, g_attn = fb.attn_bwd(x, dx2, w, heads, eps)
        torch.cuda.synchronize()
        outs = [dx2, dx, *g_mlp.values(), *g_attn.values()]
        ref = ref or outs
        same = all(torch.equal(p, q) for p, q in zip(outs, ref))
        mlp_ms = time_ms(lambda: fb.mlp_bwd(x, dy, w, eps, True), iters=30)
        attn_ms = time_ms(lambda: fb.attn_bwd(x, dx2, w, heads, eps), iters=30)
        regs = [f"{src}: {r}" for src in SOURCES
                for r in ptxas_report(libs[(g, src)][1], nt)
                if r.startswith(("attention_bwd", "rowblock", "wgrad", "reduce_all"))]
        print(f"[sweep] AB_WARPS {g[0]} GEMM_RING {g[1]}: mlp_bwd B={a.batch} {mlp_ms:.4f} ms, "
              f"attn_bwd {attn_ms:.4f} ms; bits equal to the first geometry: {same}")
        for r in regs:
            print(f"[sweep]   {r}")
        for name, fn in (("mlp_bwd", lambda: fb.mlp_bwd(x, dy, w, eps, True)),
                         ("attn_bwd", lambda: fb.attn_bwd(x, dx2, w, heads, eps))):
            for line in stage_breakdown(fn, name, top=8):
                print(f"[sweep]   {line}")
        if not same:
            return 1
    if a.parent:
        parent_run("last")
    print(f"[sweep] ViT-Tiny one layer, B={a.batch} S={a.seq} bf16 on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
