"""The traced run's records: the benchmark's spans and the profiler's trace.

Spans are the benchmark's own, around its calls into the program; each edge
waits for the device (``torch.cuda.synchronize``), so a span holds the work
it launched.  Spans are kept in memory and read when the run ends.

The profiler (``torch.profiler``, host and CUDA activity) records steps run
after the window, at least one and as many as fill ``trace_seconds``.
Its trace is reduced to: the traced window (from the first traced step's
start to the last one's end), the time in which any operation ran on the
device (the union of their intervals), each device operation's count and
seconds, the kernel launches, and the idle gaps labelled by what the host
was doing (the innermost host operation at the gap's middle).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

STEP = "portbench.step"


class Spans:
    """Seconds of each named span, one entry each time it closes."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.cuda = on, device.type == "cuda"
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        if not self.on:
            yield
            return
        self._sync()
        with torch.profiler.record_function(f"portbench.{name}"):
            t0 = time.perf_counter()
            yield
            self._sync()
            self.seconds[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced steps, first start to last end
    steps: int  # traced steps
    busy_s: float  # time in which an operation ran on the device
    ops: Dict[str, Tuple[int, float]]  # device operation -> (count, seconds)
    kernels: int  # kernel launches (device operations but copies and sets)
    gaps: Dict[str, float]  # host activity -> idle seconds of the device


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _label_gaps(host: List[Tuple[int, int, str]], gaps: List[Tuple[int, int]]) -> Dict[str, float]:
    """Each gap's seconds under the innermost host operation open at its middle
    (``host``: one thread's nested operations as (start, end, name))."""
    out: Dict[str, float] = collections.defaultdict(float)
    points = sorted(((a + b) // 2, b - a) for a, b in gaps)
    stack: List[Tuple[int, int, str]] = []
    events = sorted(host)
    i = 0
    for mid, length in points:
        while i < len(events) and events[i][0] <= mid:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        out[stack[-1][2] if stack else "host outside any operation"] += length * 1e-9
    return dict(out)


def reduce(prof) -> Optional[Trace]:
    """The :class:`Trace` of a profiler run whose steps were marked ``STEP``."""
    events = prof.profiler.kineto_results.events()
    steps = [e for e in events if e.name() == STEP]
    if not steps:
        return None
    w0, w1 = min(e.start_ns() for e in steps), max(e.end_ns() for e in steps)
    thread = steps[0].start_thread_id()
    device, host = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith("portbench."):
                continue  # a span's mirror on the device's timeline, not an operation
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if a < b:
                device.append((a, b, e.name()))
        elif e.start_thread_id() == thread and w0 <= e.start_ns() < w1:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    ops: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        ops[name][0] += 1
        ops[name][1] += (b - a) * 1e-9
    busy = _union([(a, b) for a, b, _ in device])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2) if edges[j + 1] > edges[j]]
    kernels = sum(n for name, (n, _) in ops.items() if not name.startswith(("Memcpy", "Memset")))
    return Trace(window_s=(w1 - w0) * 1e-9, steps=len(steps), busy_s=sum(b - a for a, b in busy) * 1e-9,
                 ops={k: (int(v[0]), v[1]) for k, v in ops.items()}, kernels=kernels,
                 gaps=_label_gaps(host, gaps))


def profiler(device: torch.device):
    """A profiler of host and, on a card, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def breakdown(trace: Trace) -> Dict[str, List]:
    """The ten device operations that took most time and the ten host
    activities under which the device idled longest, in seconds."""
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {"device_ops": [[name, s] for name, s in top({k: v[1] for k, v in trace.ops.items()})],
            "idle_gaps": [[name, s] for name, s in top(trace.gaps)]}
