#!/usr/bin/env python3
"""Time the PyTorch port's head_dim 16-48 attention routes above 256 keys
(vit2spn_tpu_torch/csrc/general_long.cuh: gl_fwd_kernel, gl_core_kernel,
gl_flash_rows_kernel / _cols_kernel) at S <= 256, beside the register-row
kernels that run there (attention_bwd_kernel, flash_fwd_tc,
flash_bwd_rows_tc / _cols_tc), on one CUDA card:

    python tools/gl_short_probe.py [--batch 128] [--seq 197]

Builds layer_fwd, attn_bwd and flash_attention into build/kernels/ and
tools/gl_short_probe.cu (the general_long launchers as C entries that take
any S) into build/gl_probe/, all started together. At ViT-Tiny's width (D
192) with 12, 6 and 4 heads (head_dim 16, 32, 48) it runs the attention
stage, the backward core, the flash forward and the flash backward both
ways on the same bf16 operands, and prints for each the two times (CUDA
events after a warm-up), the share of equal bits between the two routes'
outputs and each route's largest difference from the plain twin.
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
    attention_core_call,
    attention_stage_call,
    attention_stage_plain,
    card_line,
    equal_bits,
    ptxas_report,
    time_ms,
)
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vit2spn_tpu_torch.ops import fused_block as fb  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "gl_short_probe.cu"
OUT = cuda_build.BUILD_DIR.parent / "gl_probe"
HEADS = ((16, 12), (32, 6), (48, 4))  # (head_dim, heads) at D 192
D = 192
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "gl_probe_stage": ([P, P, I, I, I, I, P], I),
    "gl_probe_core": ([P, P, P, P, I, I, I, I, P], I),
    "gl_probe_flash_fwd": ([P, P, P, P, I, I, I, I, LL, LL, P], I),
    "gl_probe_flash_bwd": ([P, P, P, P, P, P, P, P, I, I, I, I, LL, LL, P], I),
    "gl_probe_ws_floats": ([I, I, I], LL),
}


def build() -> ctypes.CDLL:
    """The probe library, its nvcc run beside build_all's."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "gl_short_probe.so"
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC}", "-o", str(so),
           str(SOURCE)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_build.build_all(("layer_fwd", "attn_bwd", "flash_attention"))
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log[-4000:]}")
    for line in ptxas_report(log, None, head_dims=True):
        print(f"[build] gl_short_probe: {line}")
    lib = ctypes.CDLL(str(so))
    for fn, (args, res) in SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed ({rc})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=197)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("gl_short_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    lib = build()
    b, s, dev = a.batch, a.seq, torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    for dh, heads in HEADS:
        qkv = torch.randn(b, s, 3 * D, generator=gen).to(torch.bfloat16).to(dev)
        datt = (0.1 * torch.randn(b, s, D, generator=gen)).to(torch.bfloat16).to(dev)
        q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(D, dim=-1))
        do = (0.1 * torch.randn(b, s, heads, dh, generator=gen)).to(torch.bfloat16).to(dev)
        bs, ts = q.stride()[:2]
        att, att2 = torch.empty_like(datt), torch.empty_like(datt)
        dqkv = torch.empty_like(qkv)
        o = torch.empty_like(do)
        dq, dk, dv = (torch.empty_like(do) for _ in range(3))
        ws = torch.empty(lib.gl_probe_ws_floats(b, s, heads), dtype=torch.float32, device=dev)

        def gl_stage():
            check(lib.gl_probe_stage(qkv.data_ptr(), att.data_ptr(), b, s, heads, D, stream),
                  "stage")
            return (att,)

        def gl_core():
            check(lib.gl_probe_core(qkv.data_ptr(), datt.data_ptr(), att2.data_ptr(),
                                    dqkv.data_ptr(), b, s, heads, D, stream), "core")
            return att2, dqkv

        def gl_flash_fwd():
            check(lib.gl_probe_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         b, s, heads, dh, bs, ts, stream), "flash forward")
            return (o,)

        def gl_flash_bwd():
            check(lib.gl_probe_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                         ws.data_ptr(), b, s, heads, dh, bs, ts, stream),
                  "flash backward")
            return dq, dk, dv

        routes = (
            ("stage", gl_stage, lambda: (attention_stage_call(fb, qkv, heads),),
             lambda: (attention_stage_plain(qkv, heads),)),
            ("core", gl_core, lambda: attention_core_call(fb, qkv, datt, heads),
             lambda: fb._attention_bwd(qkv, datt, heads)),
            ("flash_fwd", gl_flash_fwd, lambda: (fa.flash_fwd(q, k, v),),
             lambda: (fa.flash_attention_plain(q, k, v),)),
            ("flash_bwd", gl_flash_bwd, lambda: fa.flash_bwd(q, k, v, do),
             lambda: fa.flash_attention_bwd_plain(q, k, v, do)),
        )
        for name, gl, reg, twin in routes:
            got_gl = [t.clone() for t in gl()]
            got_reg = reg()
            ref = twin()
            torch.cuda.synchronize()
            share = min(equal_bits(x, y) for x, y in zip(got_gl, got_reg))
            err_gl = max(float((x.float() - r.float()).abs().max()) for x, r in zip(got_gl, ref))
            err_reg = max(float((x.float() - r.float()).abs().max())
                          for x, r in zip(got_reg, ref))
            t_gl = time_ms(gl, iters=20, warmup=3)
            t_reg = time_ms(reg, iters=20, warmup=3)
            print(f"[probe] {name} B={b} S={s} D={D} heads={heads} head_dim {dh}: "
                  f"general_long {t_gl:.4f} ms, register-row kernel {t_reg:.4f} ms "
                  f"({t_gl / t_reg:.2f}x); equal bits {share:.6f}; largest difference from "
                  f"the twin {err_gl:.6g} / {err_reg:.6g}; {card}")
        del qkv, datt, q, k, v, do, att, att2, dqkv, o, dq, dk, dv, ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
