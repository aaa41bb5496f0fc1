#!/usr/bin/env python3
"""Compare what ptxas reports for every kernel of two trees of the PyTorch
port's CUDA sources (registers, spill stores and loads, static shared
memory), on a machine with nvcc:

    python tools/ptxas_diff.py --parent build/parent [--names NAME ...]

`--parent` is a checkout of another commit (e.g. `git archive` of it,
unpacked under build/, which .gitignore lists). This tree's sources are
built by ops/cuda_build.py's build_all into build/kernels/ (reused when
already built there, e.g. by chip_smoke.py in the same call); the parent's
csrc/ is compiled with the same nvcc flags into build/ptxas_parent/, every
source's nvcc started together. Prints, per source, how many kernels both
trees hold with equal lines, every kernel whose line differs, and the
kernels only one tree holds; exits 1 if a source fails to build.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vit2spn_tpu_torch.ops import cuda_build  # noqa: E402
from vit2spn_tpu_torch.ops import fused_block as fb  # noqa: E402

OUT = cuda_build.BUILD_DIR.parent / "ptxas_parent"


def entries(log: str) -> dict:
    """{mangled kernel name: "R registers, S B spill stores, L B spill
    loads, M B smem"} of one `nvcc -Xptxas -v` log."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = f"{m.group(1)} registers, {spill}, {smem.group(1) if smem else 0} B smem"
            name = None
    return out


def build_parent(parent: Path, names) -> dict:
    """The parent tree's sources compiled with this tree's flags; {name: log}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in names:
        log = OUT / f"{name}.log"
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
               str(parent / "vit2spn_tpu_torch" / "csrc" / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT),
                       log)
    logs = {}
    for name, (proc, log) in procs.items():
        if proc.wait() != 0:
            print(f"[ptxas-diff] the parent's {name} failed to build:\n"
                  + log.read_text()[-4000:], flush=True)
            sys.exit(1)
        logs[name] = log.read_text()
    print(f"[ptxas-diff] the parent's {len(names)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return logs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--names", nargs="*", default=list(fb.KERNEL_NAMES))
    args = ap.parse_args()
    t0 = time.perf_counter()
    libs = cuda_build.build_all(args.names)
    print(f"[ptxas-diff] this tree's sources ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    parent = build_parent(args.parent.resolve(), args.names)
    for name in args.names:
        new = entries(Path(f"{libs[name]}.log").read_text())
        old = entries(parent[name])
        same = [k for k in new if k in old and new[k] == old[k]]
        diff = [k for k in new if k in old and new[k] != old[k]]
        print(f"[ptxas-diff] {name}: {len(same)} kernels in both trees with equal ptxas lines, "
              f"{len(diff)} differ, {len([k for k in new if k not in old])} only in this tree, "
              f"{len([k for k in old if k not in new])} only in the parent", flush=True)
        for k in diff:
            print(f"[ptxas-diff]   {name} differs: {k}: {old[k]} -> {new[k]}")
        for k in new:
            if k not in old:
                print(f"[ptxas-diff]   {name} new: {k}: {new[k]}")
        for k in old:
            if k not in new:
                print(f"[ptxas-diff]   {name} gone: {k}: {old[k]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
