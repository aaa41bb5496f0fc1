#!/usr/bin/env python3
"""Time the backward kernels of the PyTorch port (vit2spn_tpu_torch/csrc/
mlp_bwd.cu, attn_bwd.cu and merged_bwd.cu) by stage at other block
geometries, on one CUDA card:

    python tools/bwd_tile_sweep.py [--batch 128] [--seq 197] [--parent DIR]
        [--dtypes bfloat16 float32] [--geometries N]

For each (AB_WARPS, GEMM_RING) pair below (the first N) the three sources
are compiled with those macros (warps per (image, head) block of the
attention-backward core; weight stages in flight in the row-block GEMMs)
into build/bwd_sweep/, all builds started together; the wrappers then run
each geometry's libraries on the same ViT-Tiny layer weights and inputs, in
each dtype asked for: `mlp_bwd`, `attn_bwd` and `merged_bwd` timed with
CUDA events after a warm-up, and torch.profiler's device time per kernel
(stage) of each. Every geometry does the same arithmetic per row, query and
key, so its outputs (dx and the weight gradients) must equal the first
geometry's bit for bit, and the merged kernel's must equal the split pair's
(bf16 at D <= 256 and fp32 run the same stages in the same order). The
macros touch only the bf16 route: fp32 runs the first geometry alone, and
adds the fp32 forward routes (`layer_fwd` at the same batch, `backbone_fwd`
of 12 layers at twice it), which run the same fp32 GEMM.

With --parent DIR (an unpacked checkout of an earlier commit, e.g. the
parent of a change), that tree's sources are built too and run the same way
through the same wrappers, before and after the geometries: the before /
after of a change in one call, on one card, with the share of the parent's
output bits that the change reproduces.

Prints the card, per geometry the compiler's registers and spills of the
kernels, the times and the per-stage breakdowns.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (card_line, equal_bits, ptxas_report, random_backbone,  # noqa: E402
                        stage_breakdown, time_ms)
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops import fused_block as fb  # noqa: E402

# (AB_WARPS, GEMM_RING); the first is the kept geometry
GEOMETRIES = ((16, 4), (8, 4), (4, 4), (16, 2))
OUT = cuda_build.BUILD_DIR.parent / "bwd_sweep"
BWD = ("mlp_bwd", "attn_bwd", "merged_bwd")
FWD = ("layer_fwd", fb.KERNEL_NAME)  # the fp32 forward routes
STAGE_CALLS = 10


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


@contextlib.contextmanager
def using(libs, tag, sources):
    """The wrappers run the libraries built under `tag`. An earlier tree's
    libraries get the entry points they have typed (every wrapper passes an
    fp32 dy scratch at every width)."""
    for src in sources:
        lib = cuda_build._LIBS[src] = libs[(tag, src)][0]
        if tag == "parent":
            for fn, (args, res) in fb._SIGNATURES[src].items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
            lib.vit2spn_cuda_error_string.argtypes = [fb._I]
            lib.vit2spn_cuda_error_string.restype = ctypes.c_char_p
            lib._vit2spn_typed = True
    try:
        yield
    finally:
        for src in sources:
            cuda_build._LIBS.pop(src, None)


def flat(out):
    """A kernel's result as a list of tensors: the activations first, then
    the gradients in WEIGHT_NAMES order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if not isinstance(out[-1], dict):
        return list(out)
    dx, grads = out
    return [dx, *[grads[n] for n in fb.WEIGHT_NAMES if n in grads]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked earlier checkout whose kernels to time as well")
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--geometries", type=int, default=len(GEOMETRIES),
                    help="sweep the first N block geometries")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_tile_sweep: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}")
    geoms = GEOMETRIES[:max(1, a.geometries)]
    sources = BWD + (FWD if "float32" in a.dtypes else ())
    jobs = {}
    for i, g in enumerate(geoms):
        for src in sources if i == 0 else BWD:
            jobs[(g, src)] = (cuda_build.CSRC, src,
                              [f"-DAB_WARPS={g[0]}", f"-DGEMM_RING={g[1]}"],
                              OUT / f"{src}_w{g[0]}_r{g[1]}.so")
    if a.parent:
        for src in sources:
            jobs[("parent", src)] = (a.parent / "vit2spn_tpu_torch" / "csrc", src, [],
                                     OUT / f"{src}_parent.so")
    libs = _compile(jobs)
    d, heads, mlp, layers, eps = 192, 3, 768, 12, 1e-12
    dev = torch.device("cuda")
    nt = (a.seq + 15) // 16 * 2
    gen = torch.Generator().manual_seed(0)
    wt = random_backbone(gen, layers, d, mlp, dev)
    xs = [torch.randn(a.batch, a.seq, d, generator=gen) for _ in range(2)]
    dy = 0.1 * torch.randn(a.batch, a.seq, d, generator=gen)
    xf = torch.randn(2 * a.batch, a.seq, d, generator=gen)

    def cases(dtype):
        """{name: function running it once} at this dtype."""
        w12 = tuple(t if t.dtype == torch.float32 else t.to(dtype) for t in wt)
        w = {n: t[0] for n, t in zip(fb.WEIGHT_NAMES, w12)}
        x, x2, g = (t.to(dtype).to(dev) for t in (*xs, dy))

        def split_pair():
            dx2, grads = fb.mlp_bwd(x2, g, w, eps, True)
            dx, agrads = fb.attn_bwd(x, dx2, w, heads, eps)
            return dx, {**grads, **agrads}

        out = {"mlp_bwd": lambda: fb.mlp_bwd(x2, g, w, eps, True),
               "attn_bwd": lambda: fb.attn_bwd(x, g, w, heads, eps),
               "merged_bwd": lambda: fb.merged_bwd(x, x2, g, w, heads, eps, True),
               "split pair": split_pair}
        if dtype == torch.float32:
            w0 = tuple(t[0] for t in w12)
            xb = xf.to(dev)
            out["layer_fwd"] = lambda: fb.layer_fwd(x, w0, heads, eps, True)
            out[fb.KERNEL_NAME] = lambda: fb.fused_backbone(xb, w12, heads, eps, True)
        return out

    def run(tag, dtype, ref=None):
        """Outputs, times and stages of every case under `tag`'s libraries;
        the share of equal bits against `ref` (an earlier run's outputs)."""
        name = str(dtype)[6:]
        outs = {}
        with using(libs, tag, sources if tag in ("parent", geoms[0]) else BWD):
            fns = cases(dtype)
            if tag not in ("parent", geoms[0]):
                fns = {k: f for k, f in fns.items() if k not in FWD}
            for k, fn in fns.items():
                outs[k] = flat(fn())
            torch.cuda.synchronize()
            for k, fn in fns.items():
                if k == "split pair":
                    continue
                ms = time_ms(fn, iters=30)
                line = f"[sweep] {tag} {name} {k}: {ms:.4f} ms"
                if ref is not None:
                    share = min(equal_bits(p, q) for p, q in zip(outs[k], ref[k]))
                    line += f"; equal bits with the reference run: {100 * share:.4f}%"
                print(line)
                for ln in stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)],
                                          f"{tag} {name} {k}, {STAGE_CALLS} calls", top=10):
                    print(f"[sweep]   {ln}")
        share = min(equal_bits(p, q) for p, q in zip(outs["merged_bwd"], outs["split pair"]))
        print(f"[sweep] {tag} {name}: merged_bwd equal bits with the split pair: "
              f"{100 * share:.4f}% (least over dx and 12 gradients)")
        return outs, share

    ok = True
    for dt in a.dtypes:
        dtype = getattr(torch, dt)
        parent = run("parent", dtype)[0] if a.parent else None
        first = None
        for g in geoms if dtype == torch.bfloat16 else geoms[:1]:
            regs = [f"{src}: {r}" for src in BWD for r in ptxas_report(libs[(g, src)][1], nt)
                    if r.startswith(("attention_bwd", "rowblock", "wgrad", "reduce_all",
                                     "gemm_f32", "flash"))]
            print(f"[sweep] AB_WARPS {g[0]} GEMM_RING {g[1]} ({dt})")
            for r in regs:
                print(f"[sweep]   {r}")
            outs, merged_share = run(g, dtype, parent if first is None else first)
            if first is None:
                first = outs
            elif not all(torch.equal(p, q) for k in outs for p, q in zip(outs[k], first[k])):
                print(f"[sweep] AB_WARPS {g[0]} GEMM_RING {g[1]}: bits differ from the "
                      "first geometry")
                ok = False
            ok &= merged_share == 1.0
        if a.parent:
            run("parent", dtype, first)
    print(f"[sweep] ViT-Tiny one layer, B={a.batch} S={a.seq} ({', '.join(a.dtypes)}; "
          f"backbone_fwd fp32 at B={2 * a.batch}, {layers} layers) on {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
