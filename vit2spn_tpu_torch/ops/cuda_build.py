"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with `ctypes`. The build
happens at first use, into `build/kernels/` at the repository root (listed in
`.gitignore`), keyed by a hash of the sources and flags, so a fresh checkout
builds on its first call and later calls reuse the library. Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds each source's nvcc took in the last build_all that compiled it,
# from the start of the build
BUILD_SECONDS: Dict[str, float] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: the name plus a hash of every
    source under csrc/ and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns {name: library path}. The compiler's
    output (ptxas register and shared-memory report) is kept beside each
    library as `<library>.log`; each source's time goes to BUILD_SECONDS."""
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(f"{so}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    pending = dict(procs)
    while pending:
        for name, (proc, _, log) in list(pending.items()):
            if proc.poll() is not None:
                BUILD_SECONDS[name] = time.perf_counter() - t0
                log.close()
                del pending[name]
        if pending:
            time.sleep(0.05)
    failed = []
    for name, (proc, tmp, _) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{name}:\n{Path(f'{out[name]}.log').read_text()[-6000:]}")
            continue
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        so = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(so))
    return lib
