"""Row scatter-add variants for embedding-table updates.

Counterpart of ``kb2e_tpu/ops/scatter.py``.  The fast update accumulates
per-sample row deltas into the tables (``common/trainer.cpp:130-149``
vectorised).  Mode ``"direct"`` is one duplicate-tolerant ``index_add``;
``"dedup"`` first combines duplicate indices with a sort and a segmented
cumulative sum, then adds one row per unique id.  Both compute the same
sums, up to the order of float additions.  :func:`scatter_add_` adds into
the table it is given; :func:`scatter_add` returns a new table and leaves
its input as it was.

The two are also where per-sample contributions become table deltas, and
so the one point a data-parallel step hooks (``parallel/dist_step.py``):
under :func:`every_rank`, the indices and deltas of every rank's share of
the batch are gathered, in the batch's order, before the add;
:func:`touched` gives the rows the whole batch touches, and :func:`summed`
sums a dense contribution (PTransE's gradients) over the ranks.  Without a
hook they are what they were on one device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

# The data-parallel hook in force (``parallel/dist_step.py::RowGather``), or None.
_hook = None


@contextlib.contextmanager
def every_rank(hook) -> Iterator[None]:
    """Route :func:`scatter_add`, :func:`touched` and :func:`summed` through ``hook``."""
    global _hook
    outer, _hook = _hook, hook
    try:
        yield
    finally:
        _hook = outer


def touched(idx: torch.Tensor) -> torch.Tensor:
    """The row ids of ``idx`` over the whole batch (every rank's share)."""
    return idx if _hook is None else _hook.touched(idx)


def summed(x: torch.Tensor) -> torch.Tensor:
    """A dense per-rank contribution summed over the ranks."""
    return x if _hook is None else _hook.dense(x)


def _combine_duplicates(idx: torch.Tensor, delta: torch.Tensor):
    """(unique ids, their summed rows [U, -1]) of idx [M] and delta [M, ...].

    Sorts rows by id and takes per-segment sums as differences of the
    cumulative sum at segment ends.  Its boolean selections wait for the
    device, so a CUDA graph cannot hold it.
    """
    m = idx.shape[0]
    delta = delta.reshape(m, -1)
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    csum = torch.cumsum(delta[order], dim=0)
    # Row i is the END of its segment iff the next id differs.
    is_end = torch.ones(m, dtype=torch.bool, device=idx.device)
    is_end[:-1] = sidx[1:] != sidx[:-1]
    # The segment sum at an end row is csum there minus csum at the previous end.
    pos = torch.arange(m, device=idx.device)
    end_pos = torch.where(is_end, pos, -1)
    prev_end = torch.cummax(torch.cat([end_pos.new_full((1,), -1), end_pos[:-1]]), dim=0).values
    prev_csum = torch.where((prev_end >= 0)[:, None], csum[prev_end.clamp(min=0)], 0.0)
    return sidx[is_end], (csum - prev_csum)[is_end]


def scatter_add_(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor, mode: str = "direct") -> torch.Tensor:
    """Adds ``delta``'s rows [M, ...] into ``table``'s rows ``idx`` [M] (ids
    may repeat; any trailing shape, e.g. [M, k] rows or [M, k, k] TransR
    projection blocks), in place; returns ``table``."""
    if _hook is not None:
        idx, delta = _hook.rows(idx, delta)
    if mode == "dedup":
        idx, delta = _combine_duplicates(idx, delta)
        table.view(table.shape[0], -1).index_add_(0, idx, delta)
        return table
    return table.index_add_(0, idx, delta)


def scatter_add(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor, mode: str = "direct") -> torch.Tensor:
    """:func:`scatter_add_` into a copy of ``table``."""
    return scatter_add_(table.clone(memory_format=torch.contiguous_format), idx, delta, mode)
