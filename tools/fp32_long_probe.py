#!/usr/bin/env python3
"""Split the time of the fp32 attention routes above 256 keys of the PyTorch
port (vit2spn_tpu_torch/csrc/flash_f32.cuh) into staging copies and
products, on one CUDA card:

    python tools/fp32_long_probe.py [--batch 64] [--seq 577] [--heads 12]

csrc/layer_fwd.cu and csrc/attn_bwd.cu are compiled three ways into
build/fp32_probe/, all six builds started together: as they are, with
FA_F32_PROBE=1 (every product's FMAs left out: dot_rows, product, op_dots,
op_prod add nothing) and with FA_F32_PROBE=2 (every staging copy left out:
`stage` copies nothing, the products run on whatever shared memory holds).
Each build runs the fp32 attention stage (the forward) and the attention
core (the forward, then the backward pair) on the one-pass route and,
through the C entries' `multipass` argument, on the multi-pass route, on the
same fp32 operands, timed with CUDA events after a warm-up. The probe
builds compute nothing of use: only their times count. Prints the card,
each kernel's registers and spills, and per route and call the three times,
with the share of the full time that leaving out the copies, or the FMAs,
saves.
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

PROBES = {0: "full", 1: "no FMAs", 2: "no copies"}
SOURCES = ("layer_fwd", "attn_bwd")
OUT = cuda_build.BUILD_DIR.parent / "fp32_probe"


def build():
    """{probe: {source: library}}, every build started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for probe in PROBES:
        for src in SOURCES:
            so = OUT / f"{src}_{probe}.so"
            cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-DFA_F32_PROBE={probe}", "-o",
                   str(so), str(cuda_build.CSRC / f"{src}.cu")]
            procs[(probe, src)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (probe, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {probe} {src}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (args, res) in _SIGNATURES[src].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs.setdefault(probe, {})[src] = lib
        report = [ln for ln in ptxas_report(log, 0) if "f32_kernel" in ln]
        print(f"[build] {PROBES[probe]} {src}: " + "; ".join(report))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=577)
    ap.add_argument("--heads", type=int, default=12)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_long_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    libs = build()
    b, s, h = a.batch, a.seq, a.heads
    d = 64 * h
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, s, 3 * d, generator=gen).cuda()
    datt = (0.1 * torch.randn(b, s, d, generator=gen)).cuda()
    att, att2, dqkv = torch.empty_like(datt), torch.empty_like(datt), torch.empty_like(qkv)
    ws = torch.empty(b * h * s * 3, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    times = {}
    for probe, lib in libs.items():
        for multipass in (0, 1):
            calls = {
                "stage": lambda: check(lib["layer_fwd"].vit2spn_attention_stage_f32(
                    qkv.data_ptr(), att.data_ptr(), b, s, h, d, multipass, stream)),
                "core": lambda: check(lib["attn_bwd"].vit2spn_attention_core_f32(
                    qkv.data_ptr(), datt.data_ptr(), att2.data_ptr(), dqkv.data_ptr(),
                    ws.data_ptr(), b, s, h, d, multipass, stream)),
            }
            for name, fn in calls.items():
                times[(probe, multipass, name)] = time_ms(fn, iters=5, warmup=1)
    for multipass, route in ((0, "one-pass"), (1, "multi-pass")):
        for name in ("stage", "core", "pair"):
            t = {p: (times[(p, multipass, name)] if name != "pair" else
                     times[(p, multipass, "core")] - times[(p, multipass, "stage")])
                 for p in PROBES}
            print(f"[probe] {route} {name}, B={b} S={s} heads={h}: "
                  + ", ".join(f"{PROBES[p]} {t[p]:.4f} ms" for p in PROBES)
                  + f"; leaving out the copies saves {100 * (1 - t[2] / t[0]):.1f}%, the FMAs "
                  f"{100 * (1 - t[1] / t[0]):.1f}%; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
