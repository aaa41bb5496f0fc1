"""Spawn ranks on one host: `launch(fn, n)` runs `fn(*args)` in n new
processes joined in one gloo group, and returns each rank's result.

The group's rendezvous is a file in a fresh temporary directory, not a TCP
port, so any number of launches may run side by side. The processes are
spawned (not forked) and import `fn` by its module path: it must be a
module-level function of an importable module, whose arguments and result
pickle (numpy arrays, not CUDA tensors). Every rank has one deadline: a rank
that raises, dies or is still running at the deadline fails the launch,
and every rank still alive is killed before `launch` raises.

`device` is every rank's device: "cuda:0" (the default) for ranks that
share one card (NCCL refuses two ranks on one device, so this group is gloo,
which takes CUDA tensors for all_reduce, broadcast and all_gather), or
"cpu" when the caller asks for CPU ranks. Without a card a "cuda:0" rank
fails, and with it the launch: nothing falls back to the CPU.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from vit2spn_tpu_torch.parallel.mesh import init_distributed


def _rank_main(rank: int, n: int, init_method: str, device: str, threads: Optional[int],
               fn: Callable, args: Sequence, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(device=device, backend="gloo", init_method=init_method,
                         rank=rank, world_size=n)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n: int, args: Sequence = (), device: str = "cuda:0",
           timeout: float = 600.0, threads: Optional[int] = None) -> list:
    """`fn(*args)` in n spawned gloo ranks on `device`; their results by rank.
    Raises RuntimeError when a rank fails and TimeoutError at `timeout`
    seconds, after killing every rank still running."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done: dict = {}
    with tempfile.TemporaryDirectory(prefix="vit2spn_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, init_method, device, threads, fn, tuple(args), results))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n:  # drain the queue before any join
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(n)) - set(done))} of {n} "
                                       f"still running after {timeout:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died (exit code "
                                           f"{procs[dead[0]].exitcode}) without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
                done[rank] = out
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return [done[r] for r in range(n)]


def call_each(calls: Sequence[tuple]) -> list:
    """[(fn, args, kwargs), ...] called in order on this rank, their results
    in a list: several runs in one launch."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]
