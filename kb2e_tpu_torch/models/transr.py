"""TransR: per-relation matrix projection scoring (counterpart of ``kb2e_tpu/models/transr.py``).

E(h, t, r) = dist( t·W_r − h·W_r − r )  under L1 or L2
(transr/transr.cpp:13-37; the reference's work-vector accumulation bug B1 is
not reproduced: projections are computed fresh).

Params: entity [N,k], relation [R,k], and the projection matrices ``proj``
[R, k, k] laid out [input dim j, output dim i], so a row projects as
``e @ W`` (the reference's ``W[r][j][i]·h[j]`` contraction), all float32.

Reference training semantics reproduced:
* W initialised to identity (transr/trainer.cpp:73-86); entity and relation
  ball-normed ``randn(0, 1/k, ±1)``, or warm-started from TransE seed files
  with the entities sphere-normed (transr/trainer.cpp:88-113,
  :meth:`TransR.warm_start_params`).
* closed-form gradient (transr/trainer.cpp:144-172):
  x = 2(t·W − h·W − r) (L1 → ±1);  W −= β·lr·outer(h−t, x);
  h −= β·lr·(W x);  t += β·lr·(W x);  r −= β·lr·x.
* constraints (transr/trainer.cpp:174-191): sphere-norm the touched e/r rows
  and every row of W_r, then the ‖e·W‖ ≤ 1 projector ``transRNorm`` on
  (h, W), (t, W) and the relation vector (the intent of bug B2).

Fast mode (``batch_update``, plain torch) is chunk-sequential: the batch is
applied ``chunk_size`` samples at a time, each chunk from its own start
snapshot, with one masked iteration of the coupled ‖a·W‖ ≤ 1 descent on the
touched pairs.  Parity mode (``sequential_update``) replays the exact
per-sample sequence through the hand-written kernel of
``ops/transr_update.py`` on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base
from kb2e_tpu_torch.ops import distances, projections, scatter, transr_update
from kb2e_tpu_torch.utils import prng


def _project(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [B, k] times their matrices w [B, k, k]: (row·W)_i."""
    return torch.einsum("bj,bji->bi", rows, w)


class TransR(base.Model):
    name = "transr"
    needs_projection = True
    # The chunk of the fast update, and the mini-batch the epoch runner feeds
    # it (train/step.py); the JAX package's measured optimum.
    chunk_size = 256
    weights_key = "proj"  # the matrices, R·k rows of k
    has_warm_start = True

    def weights_shape(self, n_relations, k):
        return (n_relations, k, k)

    def init_params(self, generator, n_entities, n_relations, cfg: EmbeddingConfig, device) -> base.Params:
        k = cfg.embedding_size
        ent = projections.ball_norm(prng.unit_bounded_init(generator, (n_entities, k), k, device))
        rel = projections.ball_norm(prng.unit_bounded_init(generator, (n_relations, k), k, device))
        proj = torch.eye(k, dtype=torch.float32, device=device).expand(n_relations, k, k).contiguous()
        return {"entity": ent, "relation": rel, "proj": proj}

    def energy(self, params, h, t, r, distance: Distance) -> torch.Tensor:
        w = params["proj"][r]
        res = _project(params["entity"][t], w) - _project(params["entity"][h], w) - params["relation"][r]
        return distances.residual_energy(res, distance)

    def project_entities(self, params, rel) -> torch.Tensor:
        # One [N,k]·[k,k] product per relation (the reference's per-relation
        # energy cache, common/evaluation.cpp:194-218).
        return params["entity"] @ params["proj"][rel]

    def _project_all(self, params, e_idx: torch.Tensor, rels: slice) -> torch.Tensor:
        """[B, R′, k]: the rows ``e_idx`` projected by each matrix of ``rels``."""
        return torch.einsum("bj,rji->bri", params["entity"][e_idx], params["proj"][rels])

    def relation_scores(self, params, h, t, rels: slice, distance: Distance) -> torch.Tensor:
        # h and t projected by every W_r′ at once, where the JAX package
        # gathers W per (pair, r′) row (D18); the same tp − hp − r order.
        res = self._project_all(params, t, rels) - self._project_all(params, h, rels) - params["relation"][rels]
        return distances.residual_energy(res, distance)

    def batch_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """Chunk-sequential fast update, as ``kb2e_tpu.models.transr.TransR.batch_update``.

        The batch is padded to whole chunks of ``min(chunk_size, B)`` (pad
        slots index row 0 and are invalid) and the chunks are applied in
        order.  Within a chunk every read sees the chunk-start tables and
        duplicate rows' deltas add up:
        * the closed-form gradients of the violating samples, scattered into
          W, the relation and the entity rows;
        * a sphere norm of every touched row (entities, relations, the rows
          of each touched W) whether or not its sample violated, pad slots
          included;
        * one masked iteration of the coupled ‖a·W‖ ≤ 1 descent on the four
          pair groups (h, r), (t, r), (corrupted, r) and (relation, r), where
          the corrupted entity is nh unless nh == ph, then nt.  W is gathered
          once per chunk and its deltas are summed across groups and
          duplicates.
        Returns (params, loss summed over the chunks).
        """
        lr = cfg.learning_rate
        dist = self.effective_distance(Distance.from_any(cfg.distance))
        keys = ("ph", "pt", "r", "nh", "nt", "valid")
        chunk = min(self.chunk_size, batch["ph"].shape[0])
        chunks = base.pad_to_chunks({key: batch[key] for key in keys}, chunk)
        n_entities = params["entity"].shape[0]
        ent, rel, proj = params["entity"], params["relation"], params["proj"]

        losses = []
        for phi, pti, ri, nhi, nti, vi in zip(*(chunks[key] for key in keys)):
            w = proj[ri]  # the one gather reused by the gradients
            he, te, ne_h, ne_t, rv = ent[phi], ent[pti], ent[nhi], ent[nti], rel[ri]
            res_pos = _project(te, w) - _project(he, w) - rv
            res_neg = _project(ne_t, w) - _project(ne_h, w) - rv
            e_pos = distances.residual_energy(res_pos, dist)
            e_neg = distances.residual_energy(res_neg, dist)
            viol = (e_pos + cfg.margin > e_neg) & vi
            losses.append(torch.sum(torch.where(viol, cfg.margin + e_pos - e_neg, 0.0)))
            m = viol.to(res_pos.dtype)[:, None]

            def xs(res):
                x = 2.0 * res
                if dist == Distance.L1:
                    x = torch.where(x > 0, 1.0, -1.0)
                return x * m

            x_pos, x_neg = xs(res_pos), xs(res_neg)
            # β = −1 (positive), +1 (corrupted); transr/trainer.cpp:147-171.
            wx_pos = torch.einsum("bji,bi->bj", w, x_pos)
            wx_neg = torch.einsum("bji,bi->bj", w, x_neg)
            idx = torch.cat([phi, pti, nhi, nti])
            d_w = lr * (torch.einsum("bj,bi->bji", he - te, x_pos) - torch.einsum("bj,bi->bji", ne_h - ne_t, x_neg))
            proj = scatter.scatter_add(proj, ri, d_w, cfg.scatter_mode)
            rel = scatter.scatter_add(rel, ri, lr * (x_pos - x_neg), cfg.scatter_mode)
            delta = torch.cat([lr * wx_pos, -lr * wx_pos, -lr * wx_neg, lr * wx_neg])
            ent = scatter.scatter_add(ent, idx, delta, cfg.scatter_mode)

            # Sphere norms of the touched rows (scatter_add returned new
            # tables); under a data-parallel step, every rank's rows.
            e_rows, r_rows = scatter.touched(idx), scatter.touched(ri)
            ent[e_rows] = projections.sphere_norm(ent[e_rows])
            rel[r_rows] = projections.sphere_norm(rel[r_rows])
            proj[r_rows] = projections.sphere_norm(proj[r_rows])

            # One masked iteration of transRNorm on the four pair groups:
            # tmp = 2·aW;  W −= lr·outer(a, tmp);  a −= lr·W'·tmp.
            corrupted = torch.where(nhi != phi, nhi, nti)
            pair_a = torch.cat([phi, pti, corrupted, n_entities + ri])
            fused = torch.cat([ent, rel])
            a4 = fused[pair_a].reshape(4, chunk, -1)
            w_upd = proj[ri]
            p4 = torch.einsum("sbj,bji->sbi", a4, w_upd)
            act = (torch.sum(p4 * p4, dim=-1, keepdim=True) > 1.0) & viol.repeat(4).reshape(4, chunk, 1)
            tmp = torch.where(act, 2.0 * p4, 0.0)
            d_w = -lr * torch.einsum("sbj,sbi->bji", a4, tmp)
            proj = scatter.scatter_add(proj, ri, d_w, cfg.scatter_mode)
            a_new = a4 - lr * torch.einsum("bji,sbi->sbj", w_upd + d_w, tmp)
            fused = scatter.scatter_add(fused, pair_a, (a_new - a4).reshape(4 * chunk, -1), cfg.scatter_mode)
            ent, rel = fused[:n_entities], fused[n_entities:]
        return {"entity": ent, "relation": rel, "proj": proj}, torch.stack(losses).sum()

    def sequential_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """The reference's per-sample update of one batch, in float32.

        Goes through ``transr_update.transr_sequential_update``: the
        hand-written kernel for CUDA tensors, its plain version for CPU
        tensors.  ``parity_impl='scan'`` is refused on the card rather than
        run as a per-sample loop there.
        """
        base.check_parity_impl(cfg, params["entity"].device)
        ent, rel, proj, loss, _, _ = transr_update.transr_sequential_update(
            *(params[key].to(torch.float32).contiguous() for key in ("entity", "relation", "proj")),
            batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"], batch["valid"],
            learning_rate=cfg.learning_rate, margin=cfg.margin,
            l1=self.effective_distance(Distance.from_any(cfg.distance)) == Distance.L1,
            max_iters=cfg.projection_max_iters,
        )
        return {"entity": ent, "relation": rel, "proj": proj}, loss

    def warm_start_params(self, params, seed_entity: np.ndarray, seed_relation: np.ndarray) -> base.Params:
        """TransE warm start (transr/trainer.cpp:88-113): the entities are
        loaded and sphere-normed, the relations loaded as they are; W stays
        as it was (identity from ``init_params``)."""
        dev = params["entity"].device
        ent = projections.sphere_norm(torch.as_tensor(np.asarray(seed_entity, np.float32), device=dev))
        rel = torch.as_tensor(np.asarray(seed_relation, np.float32), device=dev)
        return {**params, "entity": ent, "relation": rel}


MODEL = base.register(TransR())
