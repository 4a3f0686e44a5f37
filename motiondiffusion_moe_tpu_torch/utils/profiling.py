"""Tracing / profiling utilities.

Port of ``motiondiffusion_moe_tpu/utils/profiling.py`` on
``torch.profiler``:

- :func:`trace` — context manager around ``torch.profiler.profile`` (CPU
  activity, and CUDA when a card is present); writes a Chrome trace
  (``trace_<pid>_<n>.json``, readable by Perfetto or ``chrome://tracing``)
  into ``log_dir`` and yields the profiler;
- :func:`annotate` — ``torch.profiler.record_function``: a named span
  inside the trace;
- :class:`StepTimer` — wall-clock percentile timer for steady-state step
  time without a full trace. Unlike the JAX version, whose docstring says
  it blocks on device work but whose ``__exit__`` blocks on nothing, it
  synchronises the current CUDA stream at the end of each step when the
  work is on the card, so a step's time is its device time and not the
  time to launch it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the enclosed region and write its Chrome trace into
    ``log_dir``; yields the ``torch.profiler.profile`` (its
    ``trace_path`` attribute names the file once the region has ended)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def annotate(name: str):
    """Named span inside a profiler trace:
    ``with annotate('train_step'): ...``"""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with percentiles. Each step ends with a
    synchronisation of the current CUDA stream when the work is on the card
    (CUDA initialised in this process); on the CPU nothing waits."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "max_s": float(arr.max()),
        }
