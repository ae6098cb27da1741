"""Peaks of one H100 and the least time a piece of work could take on it.

The least time is the larger of the work's fp32 operations at the fp32 peak
and its bytes at the memory rate (NVIDIA's data sheet, SXM part, at the full
power limit of 700 W).  Bytes count each input read once and each output
written once, whatever the program reads again; operations count each fp32
instruction as costly as a fused multiply-add (two operations), since the
pipe issues one of either a cycle.  A share of this least time is a share of
the roofline, and can never pass 100 % unless the counts are too high.

Every per-layer metric that reads a roofline or an mfu share calls these
functions; the work of a model's update and scoring is counted beside its
plain reference (``reference/<model>.py``), from the shapes and ids of the
work the run did.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

FP32_FLOPS = 67e12  # operations/s, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

Work = Tuple[float, float]  # (operations, bytes)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time of one piece of work: operations or bytes, whichever bounds."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def least_seconds_sum(work: Iterable[Work]) -> float:
    """The least time of pieces that run one after another (each reads what
    the one before wrote, so no piece's bytes can be shared with another's)."""
    return sum(least_seconds(ops, nbytes) for ops, nbytes in work)


def rank_count_work(l1: bool, k: int, n_entities: int, group_queries: Sequence[int]) -> Work:
    """The ranking sweep of a pass: every query against every entity.

    Per (query, entity, coordinate) L1 takes a subtract and an absolute-add,
    two instructions; L2 one fused multiply-add.  Bytes: each group's [k, N]
    table read once (a group per relation where the tables are projected,
    one group otherwise), and per query its k coordinates, true energy and
    true id read and its count written.  This is the count of
    ``chip_smoke.py::bound_ms``, summed over the groups of a pass.
    """
    n_queries = sum(group_queries)
    ops = (4 if l1 else 2) * n_queries * n_entities * k
    nbytes = 4 * k * n_entities * len(group_queries) + 4 * (k + 2) * n_queries + 4 * n_queries
    return float(ops), float(nbytes)
