"""Spans, counters and trace capture: the port's one tracing module
(counterpart of ``kb2e_tpu/utils/profiling.py``).

``capture_trace`` wraps a run in ``torch.profiler`` — host ops, and the
card's kernels when CUDA is available — and exports a Chrome trace
(``trace.json``, readable by Perfetto or chrome://tracing) to the directory.

``span(name)`` marks a layer boundary of the program.  While the profiler
is not recording it returns one shared no-op context: no allocation, no
clock read, one attribute read of the profiler's own enabled flag.  While
it records, a span opens ``torch.profiler.record_function(name)``, so the
trace's host event carries the name on the profiler's clock, the clock of
the CUDA activity too, and it appends a record to this module's registry:
its name, start and end (``time.perf_counter_ns``), its parent span and the
ordinal of its root span (the eval pass or the epoch it belongs to).  A span
never waits for the device.  ``count`` and ``count_device`` add to named
counters while the profiler records (the latter a device scalar, summed on
the device and fetched once, by ``snapshot``).  ``snapshot()`` reads the
registry, ``reset()`` clears it; ``records()`` gives the spans themselves,
with their times on the profiler's clock (Unix nanoseconds).

Tracing is on exactly while a profiler records: ``capture_trace`` (the
CLIs' ``--profile-dir``) or any other ``torch.profiler`` recording.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

# ``_is_profiler_enabled`` is the flag torch.profiler sets while it records.
_profiler = torch.autograd.profiler


class SpanRecord(NamedTuple):
    """A closed span: times in Unix nanoseconds (the profiler's clock),
    ``parent`` its parent's index in ``records()`` (-1 for a root), ``root``
    the ordinal of its root span."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


class _Registry:
    """The spans and counters recorded since the last ``reset``."""

    def __init__(self):
        self.records: List[_Span] = []
        self.open: List[_Span] = []  # the spans open now, innermost last
        self.offsets: List[int] = []  # per root: Unix time less perf_counter, at its opening
        self.counts: Dict[str, int] = {}
        self.device: Dict[str, torch.Tensor] = {}


_registry = _Registry()


# The one context every span returns while the profiler is not recording.
_OFF = contextlib.nullcontext()


class _Span:
    """A recording span, and its record in the registry.  Its clocks are
    read outside ``record_function``, so the profiler's own cost of the
    event falls inside the span and not in its parent's self time."""

    __slots__ = ("name", "start", "end", "parent", "root", "child_ns", "_fn")

    def __init__(self, name: str):
        self.name, self.end = name, None
        self.child_ns = 0  # the time its closed child spans cover

    def __enter__(self) -> None:
        self.start = time.perf_counter_ns()
        reg = _registry
        self.parent = reg.open[-1] if reg.open else None
        if self.parent is None:
            self.root = len(reg.offsets)
            reg.offsets.append(time.time_ns() - time.perf_counter_ns())
        else:
            self.root = self.parent.root
        reg.records.append(self)
        reg.open.append(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()

    def __exit__(self, *exc) -> bool:
        self._fn.__exit__(*exc)
        self.end = time.perf_counter_ns()
        reg = _registry
        if reg.open and reg.open[-1] is self:
            reg.open.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end - self.start
        return False


def recording() -> bool:
    """Whether a profiler records now (and spans and counters with it)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context naming a layer of the program: a no-op unless a profiler
    records (see the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _registry.counts[name] = _registry.counts.get(name, 0) + int(n)


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the device scalar ``value`` (e.g. a ``sum()``) to counter ``name``
    on its device while a profiler records: the first value is copied, each
    later one added (one kernel).  Compute ``value`` only when
    :func:`recording` is true, so that tracing off adds no kernel."""
    if not _profiler._is_profiler_enabled:
        return
    total = _registry.device.get(name)
    if total is None:
        _registry.device[name] = value.detach().to(torch.int64, copy=True)
    else:
        total.add_(value.detach())


def snapshot() -> Dict[str, Dict]:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name: total}}``
    of the closed spans and the counters since the last ``reset``; self time
    is a span's time less the time its child spans cover.  Fetches the
    device counters (one wait for the device)."""
    spans: Dict[str, Dict] = {}
    for rec in _registry.records:
        if rec.end is None:
            continue
        s = spans.setdefault(rec.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (rec.end - rec.start) * 1e-9
        s["self_s"] += (rec.end - rec.start - rec.child_ns) * 1e-9
    counters = dict(_registry.counts)
    for name, total in _registry.device.items():
        counters[name] = counters.get(name, 0) + int(total.item())
    return {"spans": spans, "counters": counters}


def records() -> List[SpanRecord]:
    """The closed spans since the last ``reset``, in the order they opened."""
    closed = [rec for rec in _registry.records if rec.end is not None]
    index = {id(rec): i for i, rec in enumerate(closed)}
    offsets = _registry.offsets
    return [SpanRecord(rec.name, rec.start + offsets[rec.root], rec.end + offsets[rec.root],
                       -1 if rec.parent is None else index.get(id(rec.parent), -1), rec.root) for rec in closed]


def reset() -> None:
    """Clear the registry: spans, counters and root ordinals."""
    global _registry
    _registry = _Registry()


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
