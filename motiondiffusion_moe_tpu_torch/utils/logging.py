"""Structured metrics logging.

A copy of ``motiondiffusion_moe_tpu/utils/logging.py``: the reference's
console line, an in-memory history and an optional JSONL sink.
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict, defaultdict
from typing import Dict, Optional


def _as_minutes(s: float) -> str:
    m = int(s // 60)
    return f"{m}m {int(s - m * 60)}s"


def print_current_loss(start_time: float, niter_state: int,
                       losses: Dict[str, float], epoch: Optional[int] = None,
                       inner_iter: Optional[int] = None) -> None:
    prefix = ""
    if epoch is not None:
        prefix = f"epoch: {epoch:3d} "
        if inner_iter is not None:
            prefix += f"inner_iter: {inner_iter:4d} "
    elapsed = time.time() - start_time
    message = f"{prefix}niter: {niter_state:07d} time: {_as_minutes(elapsed)} "
    message += " ".join(f"{k}: {v:.4f}" for k, v in losses.items())
    print(message, flush=True)


class MetricsLogger:
    """Accumulate scalars and emit their means every ``log_every`` steps."""

    def __init__(self, log_every: int = 50, jsonl_path: Optional[str] = None):
        self.log_every = log_every
        self.jsonl_path = jsonl_path
        self._acc: Dict[str, float] = defaultdict(float)
        self._count = 0
        self.history = []

    def log(self, it: int, epoch: int, scalars: Dict[str, float],
            start_time: float) -> None:
        for k, v in scalars.items():
            self._acc[k] += v
        self._count += 1
        if it % self.log_every == 0 and self._count:
            means = OrderedDict((k, v / self._count)
                                for k, v in self._acc.items())
            print_current_loss(start_time, it, means, epoch)
            record = {"it": it, "epoch": epoch, **means}
            self.history.append(record)
            if self.jsonl_path:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            self._acc = defaultdict(float)
            self._count = 0
