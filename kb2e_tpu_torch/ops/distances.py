"""Distance / energy primitives shared by all Trans* models.

Counterpart of ``kb2e_tpu/ops/distances.py``.  A triple scores as a distance
in some (possibly projected) embedding space:

  E = Σ_i |t'_i − h'_i − r_i|     (L1, transe/transe.cpp:18-20)
  E = Σ_i (t'_i − h'_i − r_i)²    (L2 — sum of squares, NO sqrt,
                                   transe/transe.cpp:21-24)

Evaluation reduces to "distance from every entity row to a query point":
for corrupt-tail the query is q = h' + r, for corrupt-head q = t' − r, and in
both cases E_j = dist(e'_j, q) because L1/L2 are symmetric under negation.
"""

from __future__ import annotations

from typing import Optional

import torch

from kb2e_tpu_torch.constants import Distance


def residual_energy(res: torch.Tensor, distance: Distance) -> torch.Tensor:
    """Energy of residual vectors res = t' − h' − r over the last axis."""
    if distance == Distance.L1:
        return torch.sum(torch.abs(res), dim=-1)
    return torch.sum(res * res, dim=-1)


def squared_norms(x_t: torch.Tensor) -> torch.Tensor:
    """‖x‖² of each column of a transposed [k, M] table."""
    return torch.sum(x_t * x_t, dim=0)


def pairwise_energy(
    entities: torch.Tensor,  # [N, k] (projected) entity rows
    queries: torch.Tensor,  # [B, k] query points
    distance: Distance,
    e_sq: Optional[torch.Tensor] = None,  # [N] ‖e‖², if the caller holds them
    q_sq: Optional[torch.Tensor] = None,  # [B] ‖q‖²
) -> torch.Tensor:
    """[B, N] energies dist(e_j, q_b).

    L2 uses the expansion ‖e‖² + ‖q‖² − 2 e·q, clamped at 0 against
    cancellation.  Unlike ``kb2e_tpu`` (a [B, N, k] broadcast for L1, a
    matmul for L2), the sum over k runs one k-row at a time, in order: an
    absolute difference added per row for L1, a fused multiply-add per row
    for L2 — the order in which the rank-count kernel sums, so the two round
    alike and rank alike.  A matmul would also bring TF32 on the card.
    """
    et, qt = entities.T, queries.T
    acc = torch.zeros((queries.shape[0], entities.shape[0]), dtype=torch.float32, device=entities.device)
    for kk in range(et.shape[0]):
        if distance == Distance.L2:
            acc = torch.addcmul(acc, qt[kk][:, None], et[kk][None, :])
        else:
            acc += torch.abs(et[kk][None, :] - qt[kk][:, None])
    if distance == Distance.L1:
        return acc
    e_sq = squared_norms(et) if e_sq is None else e_sq
    q_sq = squared_norms(qt) if q_sq is None else q_sq
    return torch.clamp(q_sq[:, None] + e_sq[None, :] - 2.0 * acc, min=0.0)
