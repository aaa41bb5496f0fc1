"""Structured metric logging.

The reference's observability is print() + matplotlib artifacts
(SURVEY.md section 5). Here every metric goes through one JSONL logger
(append-only, one JSON object per event) that the plotting utilities and
benchmarks read back; stdout mirroring keeps the reference's console UX;
optional TensorBoard mirroring (`tb_dir=` or `vit2spn run --tb`) writes
numeric fields as scalars tagged `<event>/<field>`, stepped per event type.
"""

from __future__ import annotations

import json
import numbers
import os
import sys
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tb_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._tb = None
        self._tb_steps: dict = {}
        if tb_dir:
            try:
                # tensorboard ships in this environment via torch; keep the
                # import lazy + optional so the logger never hard-depends on it
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tb_dir)
            except Exception as e:  # noqa: BLE001 — degrade to JSONL only
                print(f"[warning] tensorboard unavailable ({e}); "
                      "JSONL logging only", file=sys.stderr)

    def log(self, event: str, **fields) -> dict:
        record = {"event": event, "time": time.time(), **fields}
        if self._fh:
            self._fh.write(json.dumps(record, default=float) + "\n")
        if self._tb is not None:
            step = self._tb_steps[event] = self._tb_steps.get(event, -1) + 1
            for k, v in fields.items():
                if isinstance(v, numbers.Number) and not isinstance(v, bool):
                    self._tb.add_scalar(f"{event}/{k}", float(v), step)
        if self.echo:
            shown = ", ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{event}] {shown}", file=sys.stderr)
        return record

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
