#!/usr/bin/env python3
"""How often a torch.profiler trace of a short run of the PyTorch port's
kernels comes back without them, and whether padding the traced window
changes that, on one CUDA card:

    python tools/trace_window_probe.py [--traces 400] [--pad-ms 20]

Builds flash_attention into build/kernels/ and takes `--traces` traces, as
chip_smoke.py's stage_breakdown takes them (one call before, the profiler
on around STAGE_CALLS calls and a synchronize), of the fp32 flash forward
at ViT-Tiny's width with 6 heads, B = 2, S = 290 (chip_smoke.py phase 19
(b)'s smallest trace), every other one with `--pad-ms` of host sleep inside
the profiler before and after the calls. For each kind it prints how many
traces held every launch, some or none, and, over the launches it holds,
the offset of each kernel's start on the card from the start of the
`vit2spn::flash_fwd` host range that launched it (both on the trace's
clock), with its smallest, median and largest value and those of the
traces' first and last quarters.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import STAGE_CALLS, card_line, hd_operands  # noqa: E402
from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops import flash_attention as fa  # noqa: E402


def one_trace(fn, pad_s: float) -> tuple:
    """(kernels traced, [kernel start - host range start, us])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    host, kernels = [], []
    for ev in prof.events():
        dt = getattr(ev, "device_type", None)
        if dt == DeviceType.CPU and ev.name == "vit2spn::flash_fwd":
            host.append(ev.time_range.start)
        elif dt == DeviceType.CUDA and not ev.name.startswith("vit2spn::"):
            kernels.append(ev.time_range.start)
    host.sort()
    kernels.sort()
    offsets = [k - h for h, k in zip(host, kernels)] if len(host) == len(kernels) else []
    return len(kernels), offsets


def summary(offsets) -> str:
    if not offsets:
        return "none"
    return (f"min {min(offsets):.1f}, median {statistics.median(offsets):.1f}, max "
            f"{max(offsets):.1f} us over {len(offsets)} launches")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=400)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_window_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}")
    cuda_build.build_all(("flash_attention",))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    *_, q, k, v, _ = hd_operands(gen, 2, 290, 192, 6, torch.float32, dev)

    def fn():
        return [fa.flash_fwd(q, k, v) for _ in range(STAGE_CALLS)]

    kinds = {0.0: "unpadded", a.pad_ms / 1e3: f"padded {a.pad_ms:g} ms"}
    rows = {pad: [] for pad in kinds}
    t0 = time.perf_counter()
    for i in range(a.traces):
        pad = list(kinds)[i % 2]
        n, offsets = one_trace(fn, pad)
        rows[pad].append((n, offsets))
        if n != STAGE_CALLS:
            print(f"[trace] #{i} ({kinds[pad]}, {time.perf_counter() - t0:.1f} s in): {n} of "
                  f"{STAGE_CALLS} kernels; offsets held {summary(offsets)}")
    for pad, what in kinds.items():
        got = rows[pad]
        full = sum(n == STAGE_CALLS for n, _ in got)
        none = sum(n == 0 for n, _ in got)
        quarter = max(1, len(got) // 4)
        print(f"[probe] {what}: {len(got)} traces of {STAGE_CALLS} fp32 flash_fwd calls (B=2 "
              f"S=290 heads=6): {full} held every kernel, {len(got) - full - none} some, "
              f"{none} none; kernel start - host launch: "
              f"{summary([o for _, offs in got for o in offs])}; first quarter "
              f"{summary([o for _, offs in got[:quarter] for o in offs])}; last quarter "
              f"{summary([o for _, offs in got[-quarter:] for o in offs])}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
