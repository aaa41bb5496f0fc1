#!/usr/bin/env python3
"""Time the long-sequence attention routes of the PyTorch port
(vit2spn_tpu_torch/csrc/long_attention.cuh: S > 256) at other geometries,
on one CUDA card:

    python tools/long_seq_sweep.py [--batch 64] [--seq 577] [--heads 12]
                                   [--geometries 0,4,5] [--parent DIR]

For each (LA_FWD_WG, LA_FWD_STAGES, LA_CORE_WG, LA_CORE_STAGES,
LA_CORE_MINB, LA_FBWD_WG, LA_FBWD_STAGES, LA_FBWD_MINB) below (the
forward's consumer warpgroups and its ring's stages, one 64-row chunk of K,
or of K and V, each; the backward core's consumer warpgroups, its ring's
stages at most, and the blocks an SM must hold, which sets its consumers'
registers; the same three of the flash backward's two launches), or the
ones `--geometries` picks by index (the first always runs),
csrc/layer_fwd.cu, csrc/attn_bwd.cu and csrc/flash_attention.cu are compiled
with those macros into build/long_sweep/, all builds started together;
each geometry then runs the forward layer's attention stage, the backward's
attention core and the flash forward and backward on the same bf16
operands, timed with CUDA events after a warm-up. Every geometry does the
same arithmetic per 64 rows, so its outputs must equal the first
geometry's bit for bit. Prints the card, per geometry each long kernel's
registers and spills and any wgmma ptxas serialized, and the four times.

With --parent DIR (an unpacked checkout of an earlier commit, e.g. the
parent of a change), that tree's three sources are built too, with their
own defaults, and run the same way before the geometries and again after
them, with the share of each output's elements equal bit for bit to the
first geometry's: the before and after of a change in one call.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import equal_bits, ptxas_report, time_ms  # noqa: E402
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops.fused_block import _SIGNATURES  # noqa: E402

GEOMETRIES = (  # the first: the default
    (2, 6, 1, 4, 2, 1, 4, 2), (2, 4, 1, 3, 2, 1, 4, 2), (2, 6, 2, 4, 1, 1, 4, 2),
    (3, 6, 1, 3, 2, 1, 4, 2), (2, 6, 1, 4, 2, 2, 6, 1), (2, 6, 1, 4, 2, 1, 3, 2),
)
KNOBS = ("LA_FWD_WG", "LA_FWD_STAGES", "LA_CORE_WG", "LA_CORE_STAGES", "LA_CORE_MINB",
         "LA_FBWD_WG", "LA_FBWD_STAGES", "LA_FBWD_MINB")
SOURCES = ("layer_fwd", "attn_bwd", "flash_attention")
OUT = cuda_build.BUILD_DIR.parent / "long_sweep"


def build(geoms, parent=None):
    """{geometry or "parent": {source: library}}, every build started
    together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for g in geoms:
        for src in SOURCES:
            jobs[(g, src)] = (cuda_build.CSRC, [f"-D{n}={v}" for n, v in zip(KNOBS, g)],
                              OUT / f"{src}_{'_'.join(map(str, g))}.so")
    if parent is not None:
        for src in SOURCES:
            jobs[("parent", src)] = (parent / "vit2spn_tpu_torch" / "csrc", [],
                                     OUT / f"{src}_parent.so")
    procs = {}
    for (g, src), (csrc, defs, so) in jobs.items():
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-o", str(so),
               str(csrc / f"{src}.cu")]
        procs[(g, src)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (g, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {g} {src}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (args, res) in _SIGNATURES[src].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs.setdefault(g, {})[src] = lib
        report = [ln for ln in ptxas_report(log, 0) if ln.startswith("long_")]
        print(f"[build] {g} {src}: " + "; ".join(report))
        for line in log.splitlines():  # ptxas serializing a long route's wgmma
            if "Performance Loss" in line and "long_" in line:
                print(f"[build] {g} {src}: {line.split('info    : ')[-1]}")
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=577)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--geometries", default=",".join(map(str, range(len(GEOMETRIES)))),
                    help="indices into GEOMETRIES, comma-separated")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout whose kernels run beside these")
    a = ap.parse_args()
    picked = [GEOMETRIES[0]] + [GEOMETRIES[int(i)] for i in a.geometries.split(",") if int(i)]
    if not torch.cuda.is_available():
        print("long_seq_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    libs = build(picked, a.parent)
    b, s, h = a.batch, a.seq, a.heads
    d = 64 * h
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(torch.bfloat16).cuda()
    datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(torch.bfloat16).cuda()
    q, k, v = (x.reshape(b, s, h, 64) for x in qkv.split(d, dim=-1))
    bs, ts = q.stride()[:2]
    stream = torch.cuda.current_stream().cuda_stream
    att, att2 = torch.empty_like(datt), torch.empty_like(datt)
    dqkv, o = torch.empty_like(qkv), torch.empty_like(datt)
    dq, dk, dv = (torch.empty_like(datt) for _ in range(3))
    ws = torch.empty(max(lib["flash_attention"].vit2spn_flash_bwd_workspace_floats(b, s, h)
                         for lib in libs.values()), dtype=torch.float32, device="cuda")

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    first = None
    order = picked if a.parent is None else ["parent", *picked, "parent"]
    for g in order:
        lib = libs[g]
        calls = {
            "stage": lambda: check(lib["layer_fwd"].vit2spn_attention_stage(
                qkv.data_ptr(), att.data_ptr(), b, s, h, d, stream)),
            "core": lambda: check(lib["attn_bwd"].vit2spn_attention_core(
                qkv.data_ptr(), datt.data_ptr(), att2.data_ptr(), dqkv.data_ptr(), b, s, h, d,
                stream)),
            "flash_fwd": lambda: check(lib["flash_attention"].vit2spn_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, 64, bs, ts, 0,
                stream)),
            "flash_bwd": lambda: check(lib["flash_attention"].vit2spn_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), datt.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, s, h, 64, bs, ts, 0, stream)),
        }
        times = {n: time_ms(fn, iters=10, warmup=2) for n, fn in calls.items()}
        outs = [t.clone() for t in (att, att2, dqkv, o, dq, dk, dv)]
        if g == "parent":
            if first is not None:
                shares = [equal_bits(x, y) for x, y in zip(first, outs)]
                print("[bits] the parent's outputs (att, att, dqkv, o, dq, dk, dv) equal to the "
                      f"first geometry's: {', '.join(f'{x:.6f}' for x in shares)}")
            print(f"[time] parent, B={b} S={s} heads={h}: "
                  + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()) + f"; {card}")
            continue
        same = first is None or all(torch.equal(x, y) for x, y in zip(first, outs))
        first = first or outs
        print(f"[time] (forward warpgroups, forward stages, core warpgroups, core stages, core "
              f"min blocks, flash backward warpgroups, stages, min blocks) {g}, B={b} "
              f"S={s} heads={h}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
              + f"; bits equal to the first geometry {same}; {card}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
