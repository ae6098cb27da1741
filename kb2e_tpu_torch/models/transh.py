"""TransH: hyperplane-projection scoring (counterpart of ``kb2e_tpu/models/transh.py``).

E(h, t, r) = Σ_i | t_i − (w·t)w_i − (h_i − (w·h)w_i) − r_i |   (L1 only —
the reference hard-codes L1 and ignores --distance, quirk B5;
transh/transh.cpp:15-28).

Params: entity [N,k], relation [R,k], and the per-relation hyperplane normals
``norm`` [R,k] (the reference's ``weights_``, transh/trainer.h), all float32.

Reference training semantics reproduced:
* init: randn(0, 1/k, ±1) for all tables; entity/relation ball-normed,
  normals sphere-normed (transh/trainer.cpp:61-63, 77-88).
* closed-form gradient (transh/trainer.cpp:11-46): elementwise x = ±1 of the
  doubled projected residual, the ``sum_x = Σ x_i w_i`` cross term, and the
  two-part normal update  w += β·lr·(x·(w·h − w·t) + sum_x·(h − t)).
* constraints after each update (transh/trainer.cpp:48-58): ball-norm e/r
  rows, sphere-norm w, then the coupled orthogonality projector
  norm(r,w,lr), norm(h,w,lr), norm(t,w,lr) (common/utils.cpp:79-111).

Fast mode (``batch_update``, plain torch) applies the orthogonality projector
to the whole relation table (idempotent where already satisfied) and to the
batch's touched (entity, w_r) pairs with delta scatter-adds, each call inside
a span ``kb2e.transh.project`` (``utils/profiling.py``); parity mode
(``sequential_update``) replays the exact sequence through the hand-written
kernel of ``ops/transh_update.py`` on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base
from kb2e_tpu_torch.ops import projections, scatter, transh_update
from kb2e_tpu_torch.utils import prng, profiling


def _hyperplane_residual(he, te, rv, w):
    """t − (w·t)w − (h − (w·h)w) − r, batched over the leading axis."""
    head_sum = torch.sum(w * he, dim=-1, keepdim=True)
    tail_sum = torch.sum(w * te, dim=-1, keepdim=True)
    return (te - tail_sum * w) - (he - head_sum * w) - rv, head_sum, tail_sum


class TransH(base.Model):
    name = "transh"
    uses_distance_flag = False  # quirk B5
    needs_projection = True
    weights_key = "norm"  # the hyperplane normals, one row per relation

    def weights_shape(self, n_relations, k):
        return (n_relations, k)

    def init_params(self, generator, n_entities, n_relations, cfg: EmbeddingConfig, device) -> base.Params:
        k = cfg.embedding_size
        ent = projections.ball_norm(prng.unit_bounded_init(generator, (n_entities, k), k, device))
        rel = projections.ball_norm(prng.unit_bounded_init(generator, (n_relations, k), k, device))
        w = projections.sphere_norm(prng.unit_bounded_init(generator, (n_relations, k), k, device))
        return {"entity": ent, "relation": rel, "norm": w}

    def energy(self, params, h, t, r, distance: Distance) -> torch.Tensor:
        res, _, _ = _hyperplane_residual(
            params["entity"][h], params["entity"][t], params["relation"][r], params["norm"][r]
        )
        return torch.sum(torch.abs(res), dim=-1)

    # --- evaluation hook: the whole entity table on relation ``rel``'s
    # hyperplane; queries then reduce to L1 distance sweeps.
    def project_entities(self, params, rel) -> torch.Tensor:
        w = params["norm"][rel]  # [k]
        ent = params["entity"]
        return ent - (ent @ w)[:, None] * w[None, :]

    def batch_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        ent, rel, w_tab = params["entity"], params["relation"], params["norm"]
        lr, cap = cfg.learning_rate, cfg.projection_max_iters
        ph, pt, r, nh, nt = batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"]

        rv, w = rel[r], w_tab[r]
        res_pos, hs_pos, ts_pos = _hyperplane_residual(ent[ph], ent[pt], rv, w)
        res_neg, hs_neg, ts_neg = _hyperplane_residual(ent[nh], ent[nt], rv, w)
        e_pos = torch.sum(torch.abs(res_pos), dim=-1)
        e_neg = torch.sum(torch.abs(res_neg), dim=-1)

        viol = (e_pos + cfg.margin > e_neg) & batch["valid"]
        loss = torch.sum(torch.where(viol, cfg.margin + e_pos - e_neg, 0.0))
        m = viol.to(res_pos.dtype)[:, None]

        def contributions(res, he, te, hs, ts, beta):
            # β = −1 for the positive triple, +1 for the corrupted one.
            x = torch.where(2.0 * res > 0, 1.0, -1.0) * m
            sum_x = torch.sum(x * w, dim=-1, keepdim=True)
            d_rel = (-beta * lr) * x
            d_t = (beta * lr) * x
            d_w = (beta * lr) * (x * (hs - ts) + sum_x * (he - te))
            return d_rel, d_t, d_w

        dr_p, dt_p, dw_p = contributions(res_pos, ent[ph], ent[pt], hs_pos, ts_pos, -1.0)
        dr_n, dt_n, dw_n = contributions(res_neg, ent[nh], ent[nt], hs_neg, ts_neg, +1.0)

        rel = scatter.scatter_add(rel, r, dr_p + dr_n, cfg.scatter_mode)
        w_tab = scatter.scatter_add(w_tab, r, dw_p + dw_n, cfg.scatter_mode)
        # The head's delta is the relation's (−β·lr·x).
        idx = torch.cat([ph, pt, nh, nt])
        delta = torch.cat([dr_p, dt_p, dr_n, dt_n])
        ent = scatter.scatter_add(ent, idx, delta, cfg.scatter_mode)

        # Constraints: ball e/r, sphere w (idempotent whole-table passes).
        ent = projections.ball_norm(ent)
        rel = projections.ball_norm(rel)
        w_tab = projections.sphere_norm(w_tab)

        # Orthogonality r ⊥ w over the whole relation table (no-op where the
        # constraint already holds, so untouched rows are unchanged).
        with profiling.span("kb2e.transh.project"):
            rel, w_tab = projections.orthogonality_project(rel, w_tab, lr, cap)

        # Orthogonality for the touched (entity, w_r) pairs, scattered back as
        # deltas.  Corruption replaces exactly one entity, so the distinct
        # pairs per sample are (h, r), (t, r), (corrupted entity, r);
        # cross-sample duplicates accumulate (the fast-mode approximation).
        # The three pairs of a sample share one w row: it is gathered once,
        # tiled to the three pair slots, and the three w deltas are summed
        # per sample before one scatter.
        corrupted = torch.where(nh != ph, nh, nt)
        e_idx = torch.cat([ph, pt, corrupted])
        e_rows = ent[e_idx]
        w_rows = w_tab[r].repeat(3, 1)
        with profiling.span("kb2e.transh.project"):
            e_new, w_new = projections.orthogonality_project(e_rows, w_rows, lr, cap)
        ent = scatter.scatter_add(ent, e_idx, e_new - e_rows, cfg.scatter_mode)
        dw3 = (w_new - w_rows).reshape(3, ph.shape[0], -1).sum(dim=0)
        w_tab = scatter.scatter_add(w_tab, r, dw3, cfg.scatter_mode)
        w_tab = projections.sphere_norm(w_tab)

        return {"entity": ent, "relation": rel, "norm": w_tab}, loss

    def sequential_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """The reference's per-sample update of one batch, in float32.

        Goes through ``transh_update.transh_sequential_update``: the
        hand-written kernel for CUDA tensors, its plain version for CPU
        tensors.  ``parity_impl='scan'`` is refused on the card rather than
        run as a per-sample loop there.
        """
        base.check_parity_impl(cfg, params["entity"].device)
        ent, rel, w_tab, loss, _, _ = transh_update.transh_sequential_update(
            *(params[key].to(torch.float32).contiguous() for key in ("entity", "relation", "norm")),
            batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"], batch["valid"],
            learning_rate=cfg.learning_rate, margin=cfg.margin, max_iters=cfg.projection_max_iters,
        )
        return {"entity": ent, "relation": rel, "norm": w_tab}, loss


MODEL = base.register(TransH())
