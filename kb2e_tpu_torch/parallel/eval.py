"""Entity-sharded ranking (counterpart of ``kb2e_tpu/parallel/eval.py``).

Ranking a query against all N entities is the long axis of the eval.  Under
a mesh it is cut over the ``model`` axis: each rank holds rows [row0, row1)
of the (projected) entity table, sweeps only those, and one ``all_reduce``
of the int32 counts gives the exact global rank.  The anchors, the true
energies and the filter candidates' energies come from the rank that owns
the row (the owner adds the value, the others 0; ``sharding.owned_rows``),
computed by the same formula as on one device, so every per-pair energy has
the same bits and the ranks equal the one-rank harness's.

The count on a shard is the rank-count kernel itself (K1/K2, its plain
version on the CPU), given the shard's aligned transpose and the true index
shifted by ``-row0``.  The kernel's test uses only j ≠ tidx and j < tidx, so
the shift keeps it right, also for a negative index or one past the shard
(the true entity on another rank).  CTransR's routed sweep runs on the shard
the same way, in plain torch, as ``rank_seg_clustered_sharded`` does in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.eval import ranking, ranking_cluster
from kb2e_tpu_torch.ops import distances, rank_count
from kb2e_tpu_torch.parallel.mesh import Mesh
from kb2e_tpu_torch.parallel.sharding import owned_rows


def _owned(mesh: Mesh, n_local: int, idx: torch.Tensor, row0: int, value) -> torch.Tensor:
    """``value(local_idx)`` for the ``idx`` this rank owns, 0 elsewhere,
    summed over ``model``: each entry from its owner."""
    li = idx.to(torch.int64) - row0
    owned = (li >= 0) & (li < n_local)
    if n_local == 0:
        out = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    else:
        out = torch.where(owned, value(li.clamp(0, n_local - 1)), 0.0)
    return mesh.all_reduce(out.contiguous(), "model")


def shard_squared_norms(proj_t: torch.Tensor, row0: int, n: int) -> torch.Tensor:
    """‖e‖² of this rank's columns ([k, n_local], from column ``row0``) of
    the whole [k, n] projected table, with the one-rank harness's bits:
    ``distances.squared_norms`` of a [k, n] table holding this rank's
    columns at their place and zeros elsewhere.  The card's column sum
    takes its order from the shape it reduces, so a [k, n_local] shard
    could round a column otherwise (D34); a column's sum reads only that
    column, so the zeros change nothing."""
    k, n_local = proj_t.shape
    whole = proj_t.new_zeros((k, n))
    whole[:, row0:row0 + n_local] = proj_t
    return distances.squared_norms(whole)[row0:row0 + n_local]


def local_counts(mesh: Mesh, proj_t: torch.Tensor, queries: torch.Tensor, e_true: torch.Tensor,
                 true_idx: torch.Tensor, row0: int, distance: Distance, block_size: int,
                 e_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [B]: the entities of the whole table ranking before the true
    one: the rank count on this rank's [k, n_local] shard with the true
    index shifted by ``-row0``, summed over ``model``."""
    if proj_t.shape[1] == 0:
        count = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    else:
        count = rank_count.rank_counts(proj_t, rank_count.aligned_transpose(queries), e_true.contiguous(),
                                       (true_idx.to(torch.int64) - row0).to(torch.int32).contiguous(),
                                       distance, block_size, e_sq=e_sq)
    return mesh.all_reduce(count, "model")


def rank_feed_queries_sharded(
    mesh: Mesh,
    proj: torch.Tensor,  # [n_local, k] this rank's rows of the projected table
    proj_t: torch.Tensor,  # [k, n_local], rank_count.aligned_transpose(proj)
    row0: int,
    rel_table: torch.Tensor,
    q_anchor: torch.Tensor,
    q_sign: torch.Tensor,
    q_rel: torch.Tensor,
    q_true: torch.Tensor,
    q_lo: torch.Tensor,
    q_count: torch.Tensor,
    filt_vals: torch.Tensor,
    start: int,
    distance: Distance,
    block_size: int,
    batch: int,
    kmax: int,
    e_sq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ranking.rank_feed_queries`` on an entity shard: (raw, filtered) ranks
    of one batch of the feed, the same on every rank."""
    sl = slice(start, start + batch)
    anchor, sign, rels, true_idx = q_anchor[sl], q_sign[sl], q_rel[sl], q_true[sl]
    cands = ranking.feed_candidates(q_lo[sl], q_count[sl], filt_vals, kmax)
    queries = owned_rows(mesh, proj, anchor, row0) + sign[:, None] * rel_table[rels]
    e_true = _owned(mesh, proj.shape[0], true_idx, row0,
                    lambda li: distances.residual_energy(proj[li] - queries, distance))
    raw = 1 + local_counts(mesh, proj_t, queries, e_true, true_idx, row0, distance, block_size, e_sq)
    valid = (cands >= 0) & (cands != true_idx[:, None])
    safe = torch.clamp(cands, min=0)
    e_cand = _owned(mesh, proj.shape[0], safe, row0,
                    lambda li: distances.residual_energy(proj[li] - queries[:, None, :], distance))
    beats = rank_count.beats(e_cand, safe, e_true, true_idx) & valid
    return raw, raw - torch.sum(beats, dim=1, dtype=torch.int32)


def rank_queries_clustered_sharded(
    mesh: Mesh,
    proj: torch.Tensor,  # [n_local, k] this rank's rows projected by W_r
    entity: torch.Tensor,  # [n_local, k] this rank's raw rows
    row0: int,
    anchor: torch.Tensor,  # int [B] global anchor ids
    sign: torch.Tensor,
    cluster_vecs: torch.Tensor,
    centers: torch.Tensor,
    true_idx: torch.Tensor,
    filter_cands: torch.Tensor,
    distance: Distance,
    block_size: int,
    u: torch.Tensor,  # [n_local, C] entity @ centers.T
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ranking_cluster.rank_queries_clustered`` on an entity shard: the
    routed sweep over this rank's rows in blocks of ``block_size``, the
    anchors and the routed energies of the true entity and the filter
    candidates from their owners, the counts summed over ``model``."""
    n_local = proj.shape[0]
    anchor_proj = owned_rows(mesh, proj, anchor, row0)
    anchor_raw = owned_rows(mesh, entity, anchor, row0)
    queries_c = anchor_proj[:, None, :] + sign[:, None, None] * cluster_vecs[None, :, :]
    v = anchor_raw @ centers.T
    ce_sq = torch.sum(torch.square(centers), dim=-1)

    def energy_of(idx):
        return _owned(mesh, n_local, idx, row0, lambda li: ranking_cluster.routed_energy(
            proj[li], entity[li], anchor_proj, v, sign, ce_sq, cluster_vecs, centers, distance))

    true_idx = true_idx.to(torch.int64)
    e_true = energy_of(true_idx)
    count = torch.zeros(true_idx.shape[0], dtype=torch.int32, device=proj.device)
    for start in range(0, n_local, block_size):
        stop = min(start + block_size, n_local)
        en = ranking_cluster.routed_block_energy(
            proj[start:stop], queries_c, ranking_cluster._assign(u[start:stop], v, sign, ce_sq), distance)
        idx = torch.arange(start, stop, device=proj.device)[None, :]
        count += torch.sum(rank_count.beats(en, idx, e_true, true_idx - row0), dim=1, dtype=torch.int32)
    raw = 1 + mesh.all_reduce(count, "model")
    valid = (filter_cands >= 0) & (filter_cands != true_idx[:, None])
    safe = torch.clamp(filter_cands, min=0).to(torch.int64)
    beats = rank_count.beats(energy_of(safe), safe, e_true, true_idx) & valid
    return raw, raw - torch.sum(beats, dim=1, dtype=torch.int32)
