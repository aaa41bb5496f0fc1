#!/usr/bin/env python3
"""Time the general route's wgmma attention kernels of the PyTorch port
(vit2spn_tpu_torch/csrc/general_long.cuh: the forward stage, the flash
forward, the fused backward core and the flash backward's two launches;
head_dim 16, 32, 48 above 256 tokens, 80 at every S) at other geometries,
beside an earlier tree's, on one CUDA card:

    python tools/gl_long_sweep.py [--geometries 0,1,2] [--parent DIR]
                                  [--routes stage,core,flash_fwd,flash_bwd]
                                  [--step | --step-only] [--step-impl fused|pallas]
                                  [--sdpa]

For each (GL_FWD_WG, GL_FWD_RING, GL_CORE_MINB, GL_CORE_STAGES,
GL_ONE_PASS_PROBE) below (the forward's consumer warpgroups and ring stages,
the core's blocks an SM and ring stages at most, a ring or block count of
0 taking the source's default at the head_dim; and the probe of a one-pass
forward, whose pass 3 skips its expf: its time says what a forward that
kept each exp(s - m) from pass 2 could save at most, its bits are not
compared), or the ones `--geometries` picks by index (the first, the
defaults, always runs), the sources of the routes `--routes` names
(csrc/layer_fwd.cu for the stage, csrc/attn_bwd.cu for the core,
csrc/flash_attention.cu for the flash pair; all four by default) are
compiled with those macros into build/gl_sweep/, every build started
together. Then at each case of CASES (head_dim, heads, D, B, S: ViT-Tiny's
width at 12 / 6 / 4 / 3 heads at B=64, S=577 and B=128, S=257; ViT-Huge/14's
at B=64, S=257 and 577) each geometry runs those routes on the same bf16
operands, timed with CUDA events after a warm-up; outputs must equal the
first geometry's bit for bit. Prints the card, each build's ptxas lines
for the gl_ and long_ kernels (registers, spills, static shared memory,
any wgmma ptxas serialized), and the times beside each route's bound
(chip_smoke.py long_bound_ms) and, with --sdpa, bf16 SDPA (its backward
for the core and the flash backward), a yardstick the port never calls.

With --parent DIR (an unpacked checkout of an earlier commit, e.g. the
parent of a change), that tree's sources are built too, with their own
defaults, and run the same way before the geometries and again after
them, with the share of each output's elements equal bit for bit to the
first geometry's: the before and after of a change in one call. With
--step, ViT-Huge/14's 8-layer SSP step (2 x 64 images, as chip_smoke.py
phase 20 (b) takes it: device time by wrapper, the gl_fwd_kernel,
gl_core_kernel and flash backward kernels' shares, idle) runs in a process
of its own for this tree and, with --parent, for the parent (parent,
this, this, parent), each tree's kernels built into its own
build/kernels/; the step goes through `--step-impl` ("fused", whose
layers run the stage and the core; "pallas", whose per-op blocks run the
flash forward and the flash backward); --step-only runs that alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if "--step-child" not in sys.argv:
    sys.path.insert(0, str(ROOT))

GEOMETRIES = ((2, 0, 0, 4, 0), (3, 0, 0, 4, 0), (2, 0, 3, 4, 0), (4, 0, 0, 4, 0),
              (2, 4, 0, 4, 0), (2, 0, 0, 2, 0), (2, 0, 0, 4, 1))
KNOBS = ("GL_FWD_WG", "GL_FWD_RING", "GL_CORE_MINB", "GL_CORE_STAGES", "GL_ONE_PASS_PROBE")
# the routes and the source each is built from
ROUTES = {"stage": "layer_fwd", "core": "attn_bwd", "flash_fwd": "flash_attention",
          "flash_bwd": "flash_attention"}
# (head_dim, heads, D, B, S)
CASES = ((16, 12, 192, 64, 577), (16, 12, 192, 128, 257), (32, 6, 192, 64, 577),
         (32, 6, 192, 128, 257), (48, 4, 192, 64, 577), (48, 4, 192, 128, 257),
         (64, 3, 192, 64, 577), (64, 3, 192, 128, 257), (80, 16, 1280, 64, 257),
         (80, 16, 1280, 64, 577))


def build(geoms, parent, out, sources):
    """{geometry or "parent": {source: library}} of `sources`, every build
    started together; prints each build's ptxas lines of the attention
    kernels."""
    from chip_smoke import ptxas_report
    from vit2spn_tpu_torch.ops import cuda_build
    from vit2spn_tpu_torch.ops.fused_block import _SIGNATURES

    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for g in geoms:
        for src in sources:
            jobs[(g, src)] = (cuda_build.CSRC, [f"-D{n}={v}" for n, v in zip(KNOBS, g)],
                              out / f"{src}_{'_'.join(map(str, g))}.so")
    if parent is not None:
        for src in sources:
            jobs[("parent", src)] = (parent / "vit2spn_tpu_torch" / "csrc", [],
                                     out / f"{src}_parent.so")
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
        report = [ln for ln in ptxas_report(log, None, head_dims=True)
                  if ln.startswith(("gl_fwd", "gl_core", "gl_flash", "long_attention"))]
        print(f"[build] {g} {src}: " + "; ".join(report), flush=True)
        for line in log.splitlines():  # ptxas serializing a route's wgmma
            if "Performance Loss" in line and ("gl_" in line or "long_" in line):
                print(f"[build] {g} {src}: {line.split('info    : ')[-1]}", flush=True)
    return libs


def step_child() -> int:
    """--step-child IMPL: ViT-Huge/14's 8-layer step through attn_impl IMPL
    ("fused" or "pallas") in the tree this process runs in (its
    chip_smoke.py helpers); one JSON line."""
    impl = sys.argv[sys.argv.index("--step-child") + 1]
    root = Path(os.getcwd())
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops import cuda_build
    from vit2spn_tpu_torch.ops import fused_block as fb
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(fb.KERNEL_NAMES)
    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    cfg = _apply_overrides(get_preset("ssp-scratch"), [
        *cs.VH_OVERRIDES, f"batch_size={cs.VH_MICRO}", f"accumulation_steps={cs.VH_ACCUM}",
        f"vit.num_layers={cs.VH_TRAIN_LAYERS}"])
    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl=impl, device="cuda")
    tr.attach_dataset(synthetic_dataset(image_size=28, split_sizes={"train": cfg.effective_batch},
                                        seed=cs.SEED).images)
    totals = {}
    wrappers = ((fb.KERNEL_NAME, "mlp_bwd", "attn_bwd") if impl == "fused"
                else ("flash_fwd", "flash_bwd"))
    step_s = cs.time_steps(tr, cfg.effective_batch, f"{impl} ViT-Huge/14, {root.name}",
                           cs.card_line(), wrappers, "views, embed, heads, loss, Adam, EMA",
                           reps=3, totals=totals)
    device = totals.get("device", float("nan"))
    kernels = totals.get("kernels", {})
    print(json.dumps({
        "tree": str(root), "wall_ms": 1e3 * step_s, "device_ms": device,
        "idle": 1 - device / (1e3 * step_s),
        "wrappers_ms": {w: totals.get(f"vit2spn::{w}") for w in wrappers},
        **{f"{name}_ms": sum(ms for k, (ms, _) in kernels.items() if name in k)
           for name in ("gl_fwd_kernel", "gl_core_kernel", "gl_flash_rows_kernel",
                        "gl_flash_cols_kernel")},
    }), flush=True)
    return 0


def main() -> int:
    if "--step-child" in sys.argv:
        return step_child()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometries", default=",".join(map(str, range(len(GEOMETRIES)))),
                    help="indices into GEOMETRIES, comma-separated")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout whose kernels run beside these")
    ap.add_argument("--step", action="store_true",
                    help="ViT-Huge/14's 8-layer step, this tree (and the parent's)")
    ap.add_argument("--step-impl", default="fused", choices=("fused", "pallas"),
                    help="the step's attn_impl (\"pallas\" runs the flash pair)")
    ap.add_argument("--step-only", action="store_true",
                    help="the step alone: no builds or times of the kernels")
    ap.add_argument("--sdpa", action="store_true", help="bf16 SDPA beside each time")
    ap.add_argument("--routes", default=",".join(ROUTES),
                    help="the routes to time, comma-separated (only their sources are built)")
    a = ap.parse_args()
    routes = a.routes.split(",")
    sources = tuple(dict.fromkeys(ROUTES[r] for r in routes))
    from chip_smoke import card_line, equal_bits, library_flash_bwd, long_bound_ms, time_ms

    picked = [GEOMETRIES[0]] + [GEOMETRIES[int(i)] for i in a.geometries.split(",") if int(i)]
    if not torch.cuda.is_available():
        print("gl_long_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}", flush=True)
    if a.step or a.step_only:  # the trees' full builds beside the sweep's
        trees = [ROOT] if a.parent is None else [a.parent.resolve(), ROOT, ROOT,
                                                 a.parent.resolve()]
        warm = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
                                  "from vit2spn_tpu_torch.ops import cuda_build, fused_block as "
                                  "fb; cuda_build.build_all(fb.KERNEL_NAMES)"], cwd=t)
                for t in dict.fromkeys(trees)]
    libs = {} if a.step_only else build(picked, a.parent, ROOT / "build" / "gl_sweep", sources)
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    order = picked if a.parent is None else ["parent", *picked, "parent"]

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    for dh, h, d, b, s in () if a.step_only else CASES:
        gen = torch.Generator().manual_seed(dh + s)
        qkv = torch.randn(b, s, 3 * d, generator=gen).to(torch.bfloat16).cuda()
        datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(torch.bfloat16).cuda()
        q, k, v = (x.reshape(b, s, h, dh) for x in qkv.split(d, dim=-1))
        bs, ts = q.stride()[:2]
        att, att2 = torch.zeros_like(datt), torch.zeros_like(datt)  # zeros: a route not run
        dqkv, o = torch.zeros_like(qkv), torch.zeros_like(datt)      # compares equal
        dq, dk, dv = (torch.zeros_like(datt) for _ in range(3))
        ws = torch.empty(max([lib["flash_attention"].vit2spn_flash_bwd_workspace_floats(b, s, h)
                              for lib in libs.values() if "flash_attention" in lib] + [1]),
                         dtype=torch.float32, device="cuda")
        tag = f"head_dim {dh}, D={d}, B={b} S={s} heads={h}"
        if a.sdpa:
            sdpa_in = [t.transpose(1, 2) for t in (q, k, v)]
            bwd, _ = library_flash_bwd(q, k, v, datt.reshape(b, s, h, dh))
            with torch.no_grad():
                fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(*sdpa_in), iters=10,
                                 warmup=2)
            bwd_ms = time_ms(bwd, iters=10, warmup=2)
            del bwd, sdpa_in
            bounds = {r: long_bound_ms(r, b, s, h, False, dh)[:2] for r in
                      ("attention_fwd", "attention_bwd", "flash_fwd", "flash_bwd")}
            print(f"[sdpa] {tag}: bf16 SDPA {fwd_ms:.4f} ms, its backward {bwd_ms:.4f} ms; "
                  "bounds " + ", ".join(f"{r} {ms:.4f} ms ({by})" for r, (ms, by) in
                                        bounds.items()) + f"; {card}", flush=True)
        first = None
        for g in order:
            lib = libs[g]
            calls = {
                "stage": lambda: check(lib["layer_fwd"].vit2spn_attention_stage(
                    qkv.data_ptr(), att.data_ptr(), b, s, h, d, stream)),
                "core": lambda: check(lib["attn_bwd"].vit2spn_attention_core(
                    qkv.data_ptr(), datt.data_ptr(), att2.data_ptr(), dqkv.data_ptr(), b, s, h,
                    d, stream)),
                "flash_fwd": lambda: check(lib["flash_attention"].vit2spn_flash_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, dh, bs, ts,
                    0, stream)),
                "flash_bwd": lambda: check(lib["flash_attention"].vit2spn_flash_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), datt.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, s, h, dh, bs, ts, 0,
                    stream)),
            }
            times = {n: time_ms(fn, iters=10, warmup=2) for n, fn in calls.items() if n in routes}
            outs = [t.clone() for t in (att, att2, dqkv, o, dq, dk, dv)]
            if g == "parent":
                if first is not None:
                    shares = [equal_bits(x, y) for x, y in zip(first, outs)]
                    print("[bits] the parent's outputs (att, att, dqkv, o, dq, dk, dv) equal to "
                          f"the first geometry's ({tag}): "
                          + ", ".join(f"{x:.6f}" for x in shares), flush=True)
                print(f"[time] parent, {tag}: "
                      + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()) + f"; {card}",
                      flush=True)
                continue
            probe = g[KNOBS.index("GL_ONE_PASS_PROBE")] != 0
            same = probe or first is None or all(torch.equal(x, y) for x, y in zip(first, outs))
            first = first or outs
            print(f"[time] ({', '.join(KNOBS)}) {g}, {tag}: "
                  + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
                  + (f"; the one-pass probe (bits not compared); {card}" if probe else
                     f"; core att = stage att {torch.equal(att, att2)}; bits equal to the first "
                     f"geometry {same}; {card}"), flush=True)
            if not same:
                return 1
        del qkv, datt, q, k, v, att, att2, dqkv, o, dq, dk, dv, ws
        torch.cuda.empty_cache()
    if a.step or a.step_only:
        for p in warm:
            p.wait()
        for t in trees:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--step-child",
                                   a.step_impl], cwd=t, capture_output=True, text=True,
                                  timeout=900)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            for ln in proc.stdout.splitlines():
                if ln.startswith("[profile]") or ln.startswith("[time]"):
                    print(ln, flush=True)
            if proc.returncode != 0 or not lines:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            print(f"[step] {lines[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
