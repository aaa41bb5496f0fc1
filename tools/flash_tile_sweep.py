#!/usr/bin/env python3
"""Time the bf16 flash-attention kernels of the PyTorch port
(vit2spn_tpu_torch/csrc/flash_attention.cu) at other block geometries, on
one CUDA card:

    python tools/flash_tile_sweep.py [--batch 128] [--seq 197] [--heads 3]

For each (TC_WARPS, TC_TILE) pair below the source is compiled with those
macros (warps per block, rows per block) into build/flash_sweep/, all builds
started together; each library then runs the forward and the backward on the
same (B, S, H, 64) bf16 views of one qkv, timed with CUDA events after a
warm-up. Every geometry does the same arithmetic per 16 rows, so its outputs
must equal the first geometry's bit for bit. Prints the card, per geometry
the compiler's registers and spills of the S-sized instantiations, the
dynamic shared memory per block, and both times.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import ptxas_report  # noqa: E402
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops.fused_block import _SIGNATURES  # noqa: E402

GEOMETRIES = ((4, 64), (4, 128), (4, 256), (8, 128), (8, 256), (2, 32))
OUT = cuda_build.BUILD_DIR.parent / "flash_sweep"


def build(geoms):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for w, t in geoms:
        so = OUT / f"flash_w{w}_t{t}.so"
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-DTC_WARPS={w}", f"-DTC_TILE={t}",
               "-o", str(so), str(cuda_build.CSRC / "flash_attention.cu")]
        procs[(w, t)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (args, res) in _SIGNATURES["flash_attention"].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs[key] = (lib, log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--heads", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_tile_sweep: CUDA is not available", file=sys.stderr)
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
    q, k, v = (x.reshape(b, s, h, 64) for x in qkv.split(d, dim=-1))
    do = (0.1 * torch.randn(b, s, h, 64, generator=gen)).to(torch.bfloat16).cuda()
    bs, ts = q.stride()[:2]
    stream = torch.cuda.current_stream().cuda_stream
    sp = (s + 15) // 16 * 16
    ref = None
    for (w, t), (lib, log) in libs.items():
        o = torch.empty_like(do)
        grads = [torch.empty_like(do) for _ in range(3)]
        ws = torch.empty(lib.vit2spn_flash_bwd_workspace_floats(b, s, h), device="cuda")

        def fwd():
            rc = lib.vit2spn_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       b, s, h, 64, bs, ts, 0, stream)
            assert rc == 0, rc

        def bwd():
            rc = lib.vit2spn_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                       *(g.data_ptr() for g in grads), ws.data_ptr(),
                                       b, s, h, 64, bs, ts, 0, stream)
            assert rc == 0, rc

        times = []
        for fn in (fwd, bwd):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 50)
        outs = [o.clone(), *(g.clone() for g in grads)]
        ref = ref or outs
        same = all(torch.equal(x, y) for x, y in zip(outs, ref))
        smem = (2 * sp + 16 * w) * 72 * 2, (2 * sp + 32 * w) * 72 * 2 + 3 * sp * 4
        print(f"[sweep] warps {w} tile {t}: forward {times[0]:.4f} ms, backward "
              f"{times[1]:.4f} ms; bits equal to the first geometry: {same}; dynamic shared "
              f"memory per block: forward {smem[0]} B, backward up to {smem[1]} B; "
              f"{'; '.join(r for r in ptxas_report(log, sp // 8) if '_tc' in r)}")
        if not same:
            return 1
    print(f"[sweep] B={b} S={s} H={h} bf16 on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
