"""Row scatter-add variants for embedding-table updates.

Counterpart of ``kb2e_tpu/ops/scatter.py``.  The fast update accumulates
per-sample row deltas into the tables (``common/trainer.cpp:130-149``
vectorised).  ``scatter_add_direct`` is one duplicate-tolerant
``index_add``; ``scatter_add_dedup`` first combines duplicate indices with a
sort and a segmented cumulative sum, then adds one row per unique id.  Both
compute the same sums, up to the order of float additions.  Both return a
new table: the input is not written.

:func:`scatter_add` is also where per-sample contributions become table
deltas, and so the one point a data-parallel step hooks
(``parallel/dist_step.py``): under :func:`every_rank`, the indices and
deltas of every rank's share of the batch are gathered, in the batch's
order, before the add; :func:`touched` gives the rows the whole batch
touches, and :func:`summed` sums a dense contribution (PTransE's gradients)
over the ranks.  Without a hook the three are what they were on one device.
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


def scatter_add_direct(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Plain duplicate-tolerant scatter-add (``index_add`` out of place)."""
    return table.index_add(0, idx, delta)


def scatter_add_dedup(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Scatter-add after combining duplicate indices.

    idx [M] row ids (may repeat), delta [M, ...] (any trailing shape, e.g.
    [M, k] rows or [M, k, k] TransR projection blocks).  Sorts rows by id,
    takes per-segment sums as differences of the cumulative sum at segment
    ends, and adds one row per unique id.
    """
    m = idx.shape[0]
    trailing = delta.shape[1:]
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
    seg_sum = (csum - prev_csum)[is_end]
    out = table.reshape(table.shape[0], -1).index_add(0, sidx[is_end], seg_sum)
    return out.reshape(table.shape[0], *trailing)


def scatter_add(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor, mode: str = "direct") -> torch.Tensor:
    if _hook is not None:
        idx, delta = _hook.rows(idx, delta)
    if mode == "dedup":
        return scatter_add_dedup(table, idx, delta)
    return scatter_add_direct(table, idx, delta)
