"""Trace capture and timing (counterpart of ``kb2e_tpu/utils/profiling.py``).

``capture_trace`` wraps a run in ``torch.profiler`` — host ops, and the
card's kernels when CUDA is available — and exports a Chrome trace
(``trace.json``, readable by Perfetto or chrome://tracing) to the directory.
``trace_context`` names a region of that trace
(``torch.profiler.record_function``, where the JAX package takes
``jax.profiler.TraceAnnotation``).  ``StepTimer`` is a rolling rate on the
host's clock, as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_context(label: str) -> Iterator[None]:
    """A region named ``label`` in the profiler's timeline."""
    with torch.profiler.record_function(label):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a trace of the enclosed run to ``log_dir`` (no-op when None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling units/s over the last ``window`` ticks, on the host's clock
    (``time.perf_counter``): a tick marks a step's end, and the rate counts
    the steps between the window's first and last tick."""

    def __init__(self, window: int = 50):
        self._times = collections.deque(maxlen=window)
        self._clock = time.perf_counter

    def tick(self) -> None:
        self._times.append(self._clock())

    def rate(self, units_per_tick: float) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) * units_per_tick / dt if dt > 0 else 0.0
