"""Cluster-routed rank sweep for CTransR (counterpart of ``kb2e_tpu/eval/ranking_cluster.py``).

CTransR scores a pair (h, t) under relation r with the vector r_{r,c} of the
cluster nearest the pair's entity-space offset (``models/ctransr.py``).  When
every entity is ranked, the cluster therefore depends on the *candidate*:
for corrupt-tail, candidate j has offset e_j − e_h; for corrupt-head,
e_t − e_j.  With o = s·(e_j − e_a) (s = ±1 per direction),

  argmin_c ‖o − ce_c‖²  =  argmin_c ( −2s·u[j,c] + 2s·v[b,c] + ‖ce_c‖² ),

where u = e·ce (one [N,k]·[k,C] product per relation) and v = e_a·ce per
query.  The sweep routes by that expansion, as the JAX package does; the true
entity and the filter candidates route by the same expansion with u from a
per-row product (``routed_energy``).  ``argmin`` keeps the first minimum in
both packages.

There is no kernel behind this sweep, in JAX or here: it is plain torch ops
on entity blocks of ``block_size``.  The products (u, v, and L2's q·e) run
through ``torch.matmul``, which stays in full fp32 unless a caller enables
TF32 (PyTorch's default leaves it off; ``chip_smoke.py`` turns it off).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import distances, rank_count


def _assign(u_block: torch.Tensor, v: torch.Tensor, sign: torch.Tensor, ce_sq: torch.Tensor) -> torch.Tensor:
    """Cluster ids [B, Nb] from u [Nb, C], v [B, C], sign [B], ce_sq [C]."""
    s = sign[:, None, None]
    score = -2.0 * s * u_block[None, :, :] + 2.0 * s * v[:, None, :] + ce_sq[None, None, :]
    return torch.argmin(score, dim=-1)


def routed_energy(rows_p, rows_e, anchor_proj, v, sign, ce_sq, cluster_vecs, centers, distance: Distance):
    """Cluster-routed energies of gathered candidate rows.

    ``rows_p`` / ``rows_e`` are [B, k] or [B, K, k] (projected / raw rows of
    the candidates); the anchors are per query.  Each candidate takes the
    cluster whose center is nearest its offset to the anchor and scores
    against that cluster's vector.
    """
    u = torch.einsum("...k,ck->...c", rows_e, centers)
    if rows_p.dim() == 2:
        s, vv, anchor = sign[:, None], v, anchor_proj
    else:
        s, vv, anchor = sign[:, None, None], v[:, None, :], anchor_proj[:, None, :]
    cid = torch.argmin(-2.0 * s * u + 2.0 * s * vv + ce_sq, dim=-1)
    q = anchor + s * cluster_vecs[cid]
    return distances.residual_energy(rows_p - q, distance)


def routed_block_energy(rows_p: torch.Tensor, queries_c: torch.Tensor, cid: torch.Tensor,
                        distance: Distance) -> torch.Tensor:
    """[B, Nb] routed energies of one candidate block: each (query, candidate)
    pair scores against its cluster's query vector.

    L1: the routed query vector is gathered per pair into a [B, Nb, k]
    temporary and one |q − e| sum follows (the JAX package selects it with
    C − 1 ``where``s; the same values, the same sum over k).  L2: the matmul
    expansion per cluster, selected by ``cid``, as the JAX package does.
    """
    if distance == Distance.L1:
        q = queries_c[torch.arange(queries_c.shape[0], device=cid.device)[:, None], cid]
        return torch.sum(q.sub_(rows_p[None]).abs_(), dim=-1)
    e_sq = torch.sum(torch.square(rows_p), dim=-1)
    en = None
    for c in range(queries_c.shape[1]):
        qc = queries_c[:, c, :]
        e_c = torch.clamp(torch.sum(torch.square(qc), dim=-1)[:, None] + e_sq[None, :] - 2.0 * (qc @ rows_p.T),
                          min=0.0)
        en = e_c if en is None else torch.where(cid == c, e_c, en)
    return en


def rank_queries_clustered(
    proj: torch.Tensor,  # [N, k] entity table projected by W_r
    entity: torch.Tensor,  # [N, k] raw entity table (offset space)
    anchor_proj: torch.Tensor,  # [B, k] projected anchor rows
    anchor_raw: torch.Tensor,  # [B, k] raw anchor rows
    sign: torch.Tensor,  # [B] +1 corrupt-tail, −1 corrupt-head
    cluster_vecs: torch.Tensor,  # [C, k] r_{r,c}
    centers: torch.Tensor,  # [C, k] offset-space centers
    true_idx: torch.Tensor,  # int [B]
    filter_cands: torch.Tensor,  # int [B, Kmax], -1 padded
    distance: Distance,
    block_size: int,
    u: Optional[torch.Tensor] = None,  # [N, C] entity @ centers.T, if the caller holds it
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw, filtered) 1-based int32 ranks [B] under cluster-routed energies.

    Raw rank = 1 + #{j ≠ true : E_j < E_true or (E_j = E_true and j < true)}
    over every entity, in blocks of ``block_size`` (the last one short);
    the filtered rank subtracts the valid filter candidates that beat the
    true entity.
    """
    n = proj.shape[0]
    queries_c = anchor_proj[:, None, :] + sign[:, None, None] * cluster_vecs[None, :, :]
    v = anchor_raw @ centers.T
    ce_sq = torch.sum(torch.square(centers), dim=-1)
    if u is None:
        u = entity @ centers.T

    def energy_of(idx):
        return routed_energy(proj[idx], entity[idx], anchor_proj, v, sign, ce_sq, cluster_vecs, centers, distance)

    true_idx = true_idx.to(torch.int64)
    e_true = energy_of(true_idx)
    count = torch.zeros(true_idx.shape[0], dtype=torch.int32, device=proj.device)
    for start in range(0, n, block_size):
        stop = min(start + block_size, n)
        en = routed_block_energy(proj[start:stop], queries_c, _assign(u[start:stop], v, sign, ce_sq), distance)
        idx = torch.arange(start, stop, device=proj.device)[None, :]
        count += torch.sum(rank_count.beats(en, idx, e_true, true_idx), dim=1, dtype=torch.int32)

    cand_valid = (filter_cands >= 0) & (filter_cands != true_idx[:, None])
    safe = torch.clamp(filter_cands, min=0).to(torch.int64)
    cand_beats = rank_count.beats(energy_of(safe), safe, e_true, true_idx) & cand_valid
    raw_rank = 1 + count
    return raw_rank, raw_rank - torch.sum(cand_beats, dim=1, dtype=torch.int32)

