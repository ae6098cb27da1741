"""The program's own spans and counters (``kb2e_tpu_torch/utils/profiling.py``)
as the per-layer metrics read them.

The program records spans and counters only while a profiler records, and
a traced run's profiler records only the steps after the window, so the
registry holds exactly those steps.  Each number is taken per root span
(an eval pass: ``kb2e.eval.rank_all``; an epoch: ``kb2e.train.apply`` or
``kb2e.train.sample``), never per traced step of the benchmark.  A program
that has no registry, or recorded no root span, reads as nothing (None).
"""

from __future__ import annotations

from typing import Dict, Optional


def snapshot() -> Optional[Dict]:
    """The program's ``profiling.snapshot()``, or None where it has none."""
    try:
        from kb2e_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return None if read is None else read()


def _roots(snap: Optional[Dict], root: str) -> int:
    return 0 if snap is None else snap["spans"].get(root, {}).get("count", 0)


def per_root(root: str, name: str, field: str, scale: float) -> Optional[float]:
    """Span ``name``'s ``field`` (``total_s`` or ``self_s``) summed over the
    registry, per root span ``root``, times ``scale``."""
    snap = snapshot()
    if not _roots(snap, root) or name not in snap["spans"]:
        return None
    return scale * snap["spans"][name][field] / _roots(snap, root)


def per_call(root: str, name: str, scale: float) -> Optional[float]:
    """Span ``name``'s mean time, times ``scale``, where root span ``root`` closed."""
    snap = snapshot()
    if not _roots(snap, root) or not snap["spans"].get(name, {}).get("count"):
        return None
    s = snap["spans"][name]
    return scale * s["total_s"] / s["count"]


def counters(root: str) -> Optional[Dict[str, int]]:
    """The registry's counters, where root span ``root`` closed."""
    snap = snapshot()
    return snap["counters"] if _roots(snap, root) else None
