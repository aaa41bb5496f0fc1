#!/usr/bin/env python3
"""Time the long-sequence attention routes of the PyTorch port
(vit2spn_tpu_torch/csrc/long_attention.cuh: S > 256) at other geometries,
on one CUDA card:

    python tools/long_seq_sweep.py [--batch 64] [--seq 577] [--heads 12]

For each (LA_FWD_WG, LA_FWD_STAGES, LA_CORE_WG, LA_CORE_STAGES,
LA_CORE_MINB) below (the forward's consumer warpgroups and its ring's
stages, one 64-row chunk of K, or of K and V, each; the backward core's
consumer warpgroups, its ring's stages at most, and the blocks an SM must
hold, which sets its consumers' registers), csrc/layer_fwd.cu, csrc/attn_bwd.cu and csrc/flash_attention.cu are compiled
with those macros into build/long_sweep/, all builds started together;
each geometry then runs the forward layer's attention stage, the backward's
attention core and the flash forward and backward on the same bf16
operands, timed with CUDA events after a warm-up. Every geometry does the
same arithmetic per 64 rows, so its outputs must equal the first
geometry's bit for bit. Prints the card, per geometry each kernel's
registers and spills, and the four times.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import ptxas_report, time_ms  # noqa: E402
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops.fused_block import _SIGNATURES  # noqa: E402

GEOMETRIES = ((2, 6, 1, 4, 2), (2, 4, 1, 3, 2), (2, 6, 2, 4, 1), (3, 6, 1, 3, 2))  # the first: the default
SOURCES = ("layer_fwd", "attn_bwd", "flash_attention")
OUT = cuda_build.BUILD_DIR.parent / "long_sweep"


def build(geoms):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for g in geoms:
        defs = [f"-D{n}={v}" for n, v in zip(
            ("LA_FWD_WG", "LA_FWD_STAGES", "LA_CORE_WG", "LA_CORE_STAGES", "LA_CORE_MINB"), g)]
        for src in SOURCES:
            so = OUT / f"{src}_{'_'.join(map(str, g))}.so"
            cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-o", str(so),
                   str(cuda_build.CSRC / f"{src}.cu")]
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
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("long_seq_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    libs = build(GEOMETRIES)
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
    ws = torch.empty(b * h * s * 3, dtype=torch.float32, device="cuda")

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    first = None
    for g, lib in libs.items():
        calls = {
            "stage": lambda: check(lib["layer_fwd"].vit2spn_attention_stage(
                qkv.data_ptr(), att.data_ptr(), b, s, h, d, stream)),
            "core": lambda: check(lib["attn_bwd"].vit2spn_attention_core(
                qkv.data_ptr(), datt.data_ptr(), att2.data_ptr(), dqkv.data_ptr(), b, s, h, d,
                stream)),
            "flash_fwd": lambda: check(lib["flash_attention"].vit2spn_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, bs, ts, 0,
                stream)),
            "flash_bwd": lambda: check(lib["flash_attention"].vit2spn_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), datt.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, s, h, bs, ts, 0, stream)),
        }
        times = {n: time_ms(fn, iters=10, warmup=2) for n, fn in calls.items()}
        outs = [t.clone() for t in (att, att2, dqkv, o, dq, dk, dv)]
        same = first is None or all(torch.equal(x, y) for x, y in zip(first, outs))
        first = first or outs
        print(f"[time] (forward warpgroups, forward stages, core warpgroups, core stages, core "
              f"min blocks) {g}, B={b} "
              f"S={s} heads={h}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
              + f"; bits equal to the first geometry {same}; {card}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
