"""Trace capture (counterpart of ``kb2e_tpu/utils/profiling.py``).

``capture_trace`` wraps a run in ``torch.profiler`` — host ops, and the
card's kernels when CUDA is available — and exports a Chrome trace
(``trace.json``, readable by Perfetto or chrome://tracing) to the directory.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


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
