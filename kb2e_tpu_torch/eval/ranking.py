"""Rank-against-all-entities evaluation core (counterpart of ``kb2e_tpu/eval/ranking.py``).

Reference algorithm (``common/evaluation.cpp:124-179``): for each test triple
and each corruption direction, score *all* entities, sort ascending, and scan:

* raw rank      = 1-based position of the true entity,
* filtered rank = 1 + number of entities ranked before the true one whose
  corrupted triple is NOT a known-good triple (train ∪ valid ∪ test).

As in ``kb2e_tpu``, the rank is computed as a *count*, with ties broken by
entity id (quirk B9):

  raw_rank(b)  = 1 + #{ j ≠ true : E_j < E_true  or  (E_j = E_true and j < true) }

The count is :func:`kb2e_tpu_torch.ops.rank_count.rank_counts`: the CUDA
kernel on the card, its plain version on the CPU.  The filtered correction
subtracts the known-good entities ranked before the true one, from short
per-query candidate lists, at the cost of one gather.

The port's sweeps take the real entity table: the kernel masks the ragged
edge and the plain version runs its last block short, so ``kb2e_tpu``'s
``pad_entities`` (1e30 rows up to a block multiple) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import distances, rank_count


def _filtered_correction(
    proj: torch.Tensor,
    queries: torch.Tensor,
    true_idx: torch.Tensor,
    filter_cands: torch.Tensor,
    e_true: torch.Tensor,
    distance: Distance,
) -> torch.Tensor:
    """# of known-good candidates ranked before the true entity (per query)."""
    cand = filter_cands  # [B, Kmax], -1 padded
    cand_valid = (cand >= 0) & (cand != true_idx[:, None])
    safe_cand = torch.clamp(cand, min=0)
    cand_rows = proj[safe_cand]  # [B, Kmax, k]
    e_cand = distances.residual_energy(cand_rows - queries[:, None, :], distance)
    cand_beats = rank_count.beats(e_cand, safe_cand, e_true, true_idx) & cand_valid
    return torch.sum(cand_beats, dim=1, dtype=torch.int32)


def rank_queries(
    proj: torch.Tensor,  # [N, k] projected entity table
    queries: torch.Tensor,  # [B, k] query points
    true_idx: torch.Tensor,  # int32 [B]
    filter_cands: torch.Tensor,  # int [B, Kmax] known-good entity ids, -1 padded
    distance: Distance,
    block_size: int,
    proj_t: Optional[torch.Tensor] = None,  # [k, N], if the caller holds it
    e_sq: Optional[torch.Tensor] = None,  # [N] ‖e‖² of proj_t's columns (L2), if the caller holds them
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (raw_rank, filtered_rank), both int32 [B], 1-based.

    Counterpart of both ``ranking.rank_queries`` and
    ``ranking.rank_queries_pallas``: the raw count is the rank-count kernel.
    The transposed tables are built in the kernel's aligned layout
    (``rank_count.aligned_transpose``), so it reads them in place.
    """
    if proj_t is None:
        proj_t = rank_count.aligned_transpose(proj)
    # True energies on the direct residual formula (ranking.py:222).
    e_true = distances.residual_energy(proj[true_idx] - queries, distance)
    raw_count = rank_count.rank_counts(
        proj_t,
        rank_count.aligned_transpose(queries),
        e_true.contiguous(),
        true_idx.to(torch.int32).contiguous(),
        distance,
        block_size,
        e_sq=e_sq,
    )
    filt_correction = _filtered_correction(proj, queries, true_idx, filter_cands, e_true, distance)
    raw_rank = 1 + raw_count
    return raw_rank, raw_rank - filt_correction


def feed_candidates(lo: torch.Tensor, cnt: torch.Tensor, filt_vals: torch.Tensor, kmax: int) -> torch.Tensor:
    """[B, kmax] filter candidates of a feed batch: ``filt_vals`` at
    ``lo + iota`` where ``iota < cnt``, else -1."""
    iota = torch.arange(kmax, dtype=torch.int32, device=filt_vals.device)[None, :]
    safe = torch.clamp(lo[:, None] + iota, max=max(filt_vals.shape[0] - 1, 0))
    return torch.where(iota < cnt[:, None], filt_vals[safe], -1)


def rank_feed_queries(
    proj: torch.Tensor,  # [N, k]
    proj_t: torch.Tensor,  # [k, N], rank_count.aligned_transpose(proj)
    rel_table: torch.Tensor,  # [R, k]
    q_anchor: torch.Tensor,  # int32 [Q_pad] — whole-eval feed, on the device
    q_sign: torch.Tensor,  # float32 [Q_pad]
    q_rel: torch.Tensor,  # int32 [Q_pad]
    q_true: torch.Tensor,  # int32 [Q_pad]
    q_lo: torch.Tensor,  # int32 [Q_pad] offsets into filt_vals
    q_count: torch.Tensor,  # int32 [Q_pad] filter-candidate counts
    filt_vals: torch.Tensor,  # int32 [F] concatenated sorted known-good ids
    start: int,  # batch start within the feed
    distance: Distance,
    block_size: int,
    batch: int,
    kmax: int,
    e_sq: Optional[torch.Tensor] = None,  # [N] ‖e‖² of proj_t's columns (L2), computed once per table
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank one batch of the device-resident query feed.

    The harness uploads every query's data once; a batch is then a slice at
    ``start``, its candidate lists a gather of ``filt_vals`` at
    ``lo + iota`` masked by ``count``, and its queries q = proj[anchor] ±
    r, built on the device.
    """
    sl = slice(start, start + batch)
    anchor, sign, rels, true_idx = q_anchor[sl], q_sign[sl], q_rel[sl], q_true[sl]
    filter_cands = feed_candidates(q_lo[sl], q_count[sl], filt_vals, kmax)
    queries = proj[anchor] + sign[:, None] * rel_table[rels]
    return rank_queries(proj, queries, true_idx, filter_cands, distance, block_size, proj_t=proj_t, e_sq=e_sq)
