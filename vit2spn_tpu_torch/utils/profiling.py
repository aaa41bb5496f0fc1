"""Profiling utilities (port of `vit2spn_tpu/utils/profiling.py`).

  * `device_memory_report(...)`: per-CUDA-device memory in use, its peak and
    the card's capacity, the reference's `log_gpu_memory`
    (ssp_vit2spn_tiny.py:178-181), logged at `run ssp` startup.
  * `trace(...)`: a torch.profiler trace (host ops and, on CUDA, the card's
    kernels through CUPTI) around any block, written as a gzipped chrome
    trace into a directory.
  * `op_breakdown(...)`: the newest trace's device time summed by kernel
    name and by each kernel wrapper's `vit2spn::<kernel>` range (the kernels
    that ran inside it), headless. A trace without device events (the CPU)
    falls back to the host ops' time, as the JAX package falls back to host
    spans.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import gzip
import json
import os
import shutil
import time
from typing import Callable, Optional

_WRAPPER_PREFIX = "vit2spn::"


def device_memory_report(timeout_s: Optional[float] = None) -> dict:
    """{device index: {"bytes_in_use_mb", "peak_bytes_mb",
    "bytes_limit_mb"}} for every CUDA device, from
    torch.cuda.memory_allocated, max_memory_allocated and mem_get_info;
    {} without CUDA.

    `timeout_s` makes the call best-effort: the queries run in a daemon
    thread and a hang returns {"error": ...} after the budget instead of
    blocking the entry path."""
    import torch

    def collect() -> dict:
        out = {}
        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            total = torch.cuda.mem_get_info(i)[1]
            out[str(i)] = {
                "bytes_in_use_mb": round(torch.cuda.memory_allocated(i) / 2**20, 1),
                "peak_bytes_mb": round(torch.cuda.max_memory_allocated(i) / 2**20, 1),
                "bytes_limit_mb": round(total / 2**20, 1),
            }
        return out

    if timeout_s is None:
        return collect()

    import threading

    result: dict = {}
    done = threading.Event()

    def run():
        try:
            result.update(collect())
        except Exception as e:  # noqa: BLE001 — best-effort under watchdog
            result["error"] = f"{type(e).__name__}: {e}"
        finally:
            done.set()

    threading.Thread(target=run, daemon=True).start()
    if not done.wait(timeout_s):
        # abandon the hung daemon thread; the process must not block
        return {"error": f"memory stats timed out after {timeout_s:g}s"}
    return result


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/vit2spn_trace"):
    """Profile the block (host ops; the card's kernels when CUDA is up) and
    write `<log_dir>/trace_<ns>.json.gz` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    raw = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(raw)
    # gzip at level 1: torch's own ".gz" export compresses at level 9, most
    # of the write time of an SSP epoch's trace (PERF.md, PR 9)
    with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst, 1 << 24)
    os.unlink(raw)


def latest_trace_file(log_dir: str) -> Optional[str]:
    files = sorted(glob.glob(os.path.join(log_dir, "trace_*.json.gz")))
    return files[-1] if files else None


def op_breakdown(log_dir: str, top: int = 20) -> list:
    """[(name, total_us, count)] from the newest trace, largest first: the
    device time of each CUDA kernel (by name, without its parameter list)
    and of each `vit2spn::<kernel>` wrapper range (the sum of the kernels
    that started inside it; one stream). Without device events, the host
    ops' time by name."""
    path = latest_trace_file(log_dir)
    if path is None:
        return []
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    agg = collections.defaultdict(float)
    counts = collections.Counter()
    kernels = sorted((float(e["ts"]), float(e["dur"])) for e in events
                     if e.get("cat") == "kernel")
    if kernels:
        for e in events:
            if e.get("cat") == "kernel":
                name = e["name"].split("(")[0]  # the kernel, without its parameter list
                agg[name] += e["dur"]
                counts[name] += 1
        starts = [t for t, _ in kernels]
        for e in events:
            if e.get("cat") == "gpu_user_annotation" and e["name"].startswith(_WRAPPER_PREFIX):
                t0 = float(e["ts"])
                lo = bisect.bisect_left(starts, t0)
                hi = bisect.bisect_right(starts, t0 + float(e["dur"]))
                agg[e["name"]] += sum(d for _, d in kernels[lo:hi])
                counts[e["name"]] += 1
    else:
        for e in events:
            if e.get("cat") == "cpu_op":
                agg[e["name"]] += e["dur"]
                counts[e["name"]] += 1
    rows = sorted(((k, v, counts[k]) for k, v in agg.items()), key=lambda r: -r[1])
    return rows[:top]


def profile_fn(fn: Callable, *args, log_dir: str = "/tmp/vit2spn_trace",
               warmup: bool = True, top: int = 20):
    """Trace one call of `fn(*args)` (after one untraced call with
    `warmup`) and return its op breakdown."""
    if warmup:
        fn(*args)
    with trace(log_dir):
        fn(*args)
    return op_breakdown(log_dir, top=top)
