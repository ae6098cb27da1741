"""TransE: translation scoring E(h, t, r) = dist(t − h − r).

Counterpart of ``kb2e_tpu/models/transe.py``.  Reference semantics:
* energy: transe/transe.cpp:10-28 (L1 = Σ|·|, L2 = Σ(·)² without sqrt).
* init:   randn(0, 1/k, ±6/√k) then ball-norm rows (transe/trainer.cpp:21-23,
          common/trainer.cpp:34-58).
* closed-form gradient with the reference's factor conventions (quirk B6):
  x = 2(t−h−r), L1 maps x to ±1 elementwise with sign(0) = −1
  (transe/trainer.cpp:28-41); row updates r ∓= lr·x, h ∓= lr·x, t ±= lr·x
  followed by ball-norm of the touched rows (transe/trainer.cpp:38-45).
* double-buffered batch semantics (transe/trainer.cpp:48-56): reads come from
  the batch-start snapshot; writes accumulate.  ``batch_update`` realises this
  as scatter-adds + one whole-table ball-norm (idempotent on untouched rows);
  ``sequential_update`` replays the exact per-sample interleaving, through
  the hand-written kernel of ``ops/transe_update.py`` on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base
from kb2e_tpu_torch.ops import distances, projections, scatter, transe_fast, transe_update
from kb2e_tpu_torch.utils import prng

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _residual_grad(res: torch.Tensor, distance: Distance) -> torch.Tensor:
    """The reference's per-coordinate update direction x (transe/trainer.cpp:28-36).

    L1 takes +1 where 2·res > 0 and −1 elsewhere, 0 included (``torch.sign``
    would give 0 there).
    """
    x = 2.0 * res
    if distance == Distance.L1:
        x = torch.where(x > 0, 1.0, -1.0)
    return x


class TransE(base.Model):
    name = "transe"
    # Entities and relations are both ball-normed, so the fast epoch can run
    # over one [N+R, k] table: one gather, one scatter-add and one projection
    # per batch instead of two of each.  Same deltas, same rows.
    supports_fused_table = True

    def init_params(self, generator, n_entities, n_relations, cfg: EmbeddingConfig, device) -> base.Params:
        k = cfg.embedding_size
        ent = prng.transe_init(generator, (n_entities, k), k, device)
        rel = prng.transe_init(generator, (n_relations, k), k, device)
        # prepTrain ball-norms every row after init (common/trainer.cpp:45-57).
        dt = _DTYPES[cfg.param_dtype]
        return {
            "entity": projections.ball_norm(ent).to(dt),
            "relation": projections.ball_norm(rel).to(dt),
        }

    def energy(self, params, h, t, r, distance: Distance) -> torch.Tensor:
        res = (
            params["entity"][t].to(torch.float32)
            - params["entity"][h].to(torch.float32)
            - params["relation"][r].to(torch.float32)
        )
        return distances.residual_energy(res, distance)

    def _directions(self, res_pos, res_neg, valid, cfg: EmbeddingConfig, dist: Distance):
        """Loss and the masked directions x of the violating samples."""
        e_pos = distances.residual_energy(res_pos, dist)
        e_neg = distances.residual_energy(res_neg, dist)
        viol = (e_pos + cfg.margin > e_neg) & valid
        loss = torch.sum(torch.where(viol, cfg.margin + e_pos - e_neg, 0.0))
        m = viol.to(res_pos.dtype)[:, None]
        return loss, _residual_grad(res_pos, dist) * m, _residual_grad(res_neg, dist) * m

    def batch_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        ent, rel = params["entity"], params["relation"]
        lr = cfg.learning_rate
        dist = self.effective_distance(Distance.from_any(cfg.distance))
        ph, pt, r, nh, nt = batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"]

        rv = rel[r].to(torch.float32)
        res_pos = ent[pt].to(torch.float32) - ent[ph].to(torch.float32) - rv
        res_neg = ent[nt].to(torch.float32) - ent[nh].to(torch.float32) - rv
        loss, x_pos, x_neg = self._directions(res_pos, res_neg, batch["valid"], cfg, dist)

        # Positive triple uses modifier −1, corrupted +1 (transe/trainer.cpp:26).
        rel = scatter.scatter_add(rel, r, (lr * (x_pos - x_neg)).to(rel.dtype), cfg.scatter_mode)
        idx = torch.cat([ph, pt, nh, nt])
        delta = torch.cat([lr * x_pos, -lr * x_pos, -lr * x_neg, lr * x_neg])
        ent = scatter.scatter_add(ent, idx, delta.to(ent.dtype), cfg.scatter_mode)
        return {"entity": projections.ball_norm(ent), "relation": projections.ball_norm(rel)}, loss

    def fuse_params(self, params: base.Params) -> torch.Tensor:
        return torch.cat([params["entity"], params["relation"]])

    def unfuse_params(self, table: torch.Tensor, n_entities: int) -> base.Params:
        return {"entity": table[:n_entities], "relation": table[n_entities:]}

    def fused_table_update(
        self, table: torch.Tensor, n_entities: int, batch: base.Batch, cfg: EmbeddingConfig
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch_update`` on the combined [N+R, k] table (relation row ids
        offset by ``n_entities``)."""
        lr = cfg.learning_rate
        dist = self.effective_distance(Distance.from_any(cfg.distance))
        ph, pt, r, nh, nt = batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"]
        idx = torch.cat([ph, pt, nh, nt, r + n_entities])
        rows = table[idx].to(torch.float32)
        hv, tv, nhv, ntv, rv = rows.chunk(5)
        loss, x_pos, x_neg = self._directions(tv - hv - rv, ntv - nhv - rv, batch["valid"], cfg, dist)
        delta = torch.cat([lr * x_pos, -lr * x_pos, -lr * x_neg, lr * x_neg, lr * (x_pos - x_neg)])
        table = scatter.scatter_add(table, idx, delta.to(table.dtype), cfg.scatter_mode)
        return projections.ball_norm(table), loss

    def fused_table_kernel(
        self, table: torch.Tensor, n_entities: int, batches: base.Batch, cfg: EmbeddingConfig
    ) -> transe_fast.FusedBatches:
        """``fused_table_update`` of each of ``batches``' [n, rows] batches,
        in place on the float32 ``table``, by the three launches a batch of
        ``ops/transe_fast.py`` on a card (by ``fused_table_update`` itself on
        the CPU): call the result with each batch's index in order, then read
        its ``loss`` [n]."""
        return transe_fast.FusedBatches(
            table, n_entities, batches, learning_rate=cfg.learning_rate, margin=cfg.margin,
            l1=self.effective_distance(Distance.from_any(cfg.distance)) == Distance.L1,
            plain=lambda t, batch: self.fused_table_update(t, n_entities, batch, cfg),
            group=max(1, cfg.num_negatives),
        )

    def takes_fused_table_kernel(self, k: int, rows: int) -> bool:
        return transe_fast.takes(k, rows)

    def sequential_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """The reference's per-sample update of one batch, in float32.

        Goes through ``transe_update.transe_sequential_update``: the
        hand-written kernel for CUDA tensors, its plain version for CPU
        tensors.  The port has no scan path: ``parity_impl='scan'`` is
        refused on the card rather than run as a per-sample loop there.
        """
        base.check_parity_impl(cfg, params["entity"].device)
        ent, rel, loss, _ = transe_update.transe_sequential_update(
            params["entity"].to(torch.float32).contiguous(), params["relation"].to(torch.float32).contiguous(),
            batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"], batch["valid"],
            learning_rate=cfg.learning_rate, margin=cfg.margin,
            l1=self.effective_distance(Distance.from_any(cfg.distance)) == Distance.L1,
        )
        return {"entity": ent, "relation": rel}, loss


MODEL = base.register(TransE())
