"""PTransE: path-based TransE (counterpart of ``kb2e_tpu/models/ptranse.py``).

Lin et al., EMNLP'15.  The reference ships no PTransE code, so the JAX
package is the definition this port follows.  On top of TransE's
margin-ranking triple loss, every positive triple (h, r, t) adds a path
loss: for each relation path p ∈ P(h, t) with PCRA reliability conf(p)
(``data/paths.py``),

    L_path = Σ_p conf(p) · [γ_p + ‖comp(p) − r‖₁ − ‖comp(p) − r′‖₁]₊

where r′ is a corrupted relation certified false for (h, t)
(``sampling/corruption.py::sample_relation_negatives``) and ``comp``
composes the path's relation embeddings: ADD (sum), MUL (elementwise
product) or RNN (a learned [2k, k] matrix applied left to right through
tanh).  Inverse relations (path ids ≥ R) use their own ``relation_inv``
table.

The path term's gradients come from ``torch.autograd.grad``, where the JAX
package takes ``jax.value_and_grad``, with JAX's conventions at the kinks:
the gradient of |x| at 0 is +1 (``torch.abs`` gives 0 there) and the hinge's
``torch.maximum(x, 0)`` splits a tie 0.5 / 0.5 as ``jnp.maximum`` does.  The
triple term is TransE's closed form.  Eval scores triples with TransE's
energy, so the entity task ranks through the rank-count kernel; relation
prediction may add path evidence (``eval/harness.py::relation_ranks``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base, transe
from kb2e_tpu_torch.ops import projections, scatter
from kb2e_tpu_torch.utils import prng

def compose_paths(
    rel_all: torch.Tensor,  # [2R, k] forward ++ inverse relation tables
    paths: torch.Tensor,  # int [B, P, L], −1 padded
    composition: str,
    comp_w: Optional[torch.Tensor] = None,  # [2k, k] for 'rnn'
) -> torch.Tensor:
    """Path embeddings [B, P, k] under the chosen composition.

    Padded hops contribute the composition's identity (0 for ADD, 1 for MUL,
    carry-through for RNN), so shorter paths compose exactly.  They read a
    zero row appended to the table as ``F.embedding``'s padding row, whose
    backward skips them: most hops are padding (three quarters at FB15k's
    shape), and the gradient of a plain gather would add each of them into
    one row, serially on the card.
    """
    n = rel_all.shape[0]
    valid = (paths >= 0)[..., None]  # [B, P, L, 1]
    table = torch.cat([rel_all, rel_all.new_zeros(1, rel_all.shape[1])])
    vecs = F.embedding(torch.where(paths >= 0, paths, n).long(), table, padding_idx=n)  # [B, P, L, k]
    if composition == "add":
        return torch.where(valid, vecs, 0.0).sum(dim=2)
    if composition == "mul":
        return torch.where(valid, vecs, 1.0).prod(dim=2)
    if composition == "rnn":
        if comp_w is None:
            raise ValueError("rnn composition requires comp_w")
        c = torch.where(valid[:, :, 0], vecs[:, :, 0, :], 0.0)
        for hop in range(1, paths.shape[2]):
            x = torch.cat([c, vecs[:, :, hop, :]], dim=-1)  # [B, P, 2k]
            c = torch.where(valid[:, :, hop], torch.tanh(x @ comp_w), c)
        return c
    raise ValueError(f"unknown path composition {composition!r}")


def l1_rows(x: torch.Tensor) -> torch.Tensor:
    """Σ|x| over the last axis, with JAX's gradient of |x|: sign(x), and +1
    at 0 (the sign factor is a constant, so the product's gradient is it)."""
    return torch.sum(x * torch.where(x >= 0, 1.0, -1.0), dim=-1)


class PTransE(transe.TransE):
    name = "ptranse"
    # The extra tables and the path loss do not fit TransE's fused two-table
    # epoch: its steps are ``batch_update`` a batch.
    stepper = base.Model.stepper
    # No reference binary: parity mode is the vectorised update.
    has_parity_mode = False
    has_warm_start = True
    uses_paths = True
    # ``comp_w`` exists (and is written) only for the RNN composition.
    file_extras = {"relation_inv": "relation_inv", "comp_w": "comp_w"}

    def init_params(self, generator, n_entities, n_relations, cfg: EmbeddingConfig, device) -> base.Params:
        """TransE's tables, then ``relation_inv`` from the same generator (the
        JAX package splits a key for it), all float32 whatever
        ``param_dtype`` says; RNN's ``comp_w`` starts at [½I; ½I]."""
        k = cfg.embedding_size
        params = {key: v.to(torch.float32)
                  for key, v in super().init_params(generator, n_entities, n_relations, cfg, device).items()}
        params["relation_inv"] = projections.ball_norm(prng.transe_init(generator, (n_relations, k), k, device))
        if cfg.path_composition == "rnn":
            eye = torch.eye(k, dtype=torch.float32, device=device) * 0.5
            params["comp_w"] = torch.cat([eye, eye])
        return params

    def path_loss_and_grads(self, rel: torch.Tensor, rel_inv: torch.Tensor, comp_w: Optional[torch.Tensor],
                            batch: base.Batch, cfg: EmbeddingConfig):
        """The path loss at the given tables and its gradients with respect to
        ``relation``, ``relation_inv`` and (RNN) ``comp_w`` (None otherwise).
        Path energies are L1 whatever ``--distance`` says (paper eq. 6); a
        path weighs conf where conf > 0 and both the sample and its
        corrupted relation are valid."""
        paths, conf, r, nr = batch["paths"], batch["conf"], batch["r"].long(), batch["nr"].long()
        active = (conf > 0) & batch["valid"][:, None] & batch["nr_valid"][:, None]
        w = torch.where(active, conf, 0.0)
        with torch.enable_grad():
            inputs = [rel.detach().requires_grad_(), rel_inv.detach().requires_grad_()]
            if comp_w is not None:
                inputs.append(comp_w.detach().requires_grad_())
            rel_t = inputs[0]
            pv = compose_paths(torch.cat(inputs[:2]), paths, cfg.path_composition,
                               inputs[2] if comp_w is not None else None)  # [B, P, k]
            e_pos = l1_rows(pv - F.embedding(r, rel_t)[:, None, :])
            e_neg = l1_rows(pv - F.embedding(nr, rel_t)[:, None, :])
            per = cfg.path_margin + e_pos - e_neg
            loss = cfg.path_weight * torch.sum(w * torch.maximum(per, torch.zeros_like(per)))
            grads = torch.autograd.grad(loss, inputs)
        return loss.detach(), grads[0], grads[1], grads[2] if comp_w is not None else None

    def batch_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """TransE's triple term and the path term on the batch-start tables,
        as ``kb2e_tpu.models.ptranse.PTransE.batch_update``: the triple
        deltas go into the entities and (through d_rel) the relations; the
        path gradients are taken at the pre-step ``relation`` and
        ``relation_inv``; then r ← r + d_rel − lr·∇r, r⁻¹ ← r⁻¹ − lr·∇r⁻¹,
        W ← W − lr·∇W (no norm), and a ball norm of entity, relation and
        relation_inv."""
        ent, rel, rel_inv = params["entity"], params["relation"], params["relation_inv"]
        comp_w = params.get("comp_w")
        lr = cfg.learning_rate
        dist = self.effective_distance(Distance.from_any(cfg.distance))
        ph, pt, r, nh, nt = batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"]

        rv = rel[r]
        res_pos = ent[pt] - ent[ph] - rv
        res_neg = ent[nt] - ent[nh] - rv
        loss, x_pos, x_neg = self._directions(res_pos, res_neg, batch["valid"], cfg, dist)
        d_rel = scatter.scatter_add(torch.zeros_like(rel), r, lr * (x_pos - x_neg), cfg.scatter_mode)
        idx = torch.cat([ph, pt, nh, nt])
        delta = torch.cat([lr * x_pos, -lr * x_pos, -lr * x_neg, lr * x_neg])
        ent = scatter.scatter_add(ent, idx, delta, cfg.scatter_mode)

        path_loss, g_rel, g_inv, g_w = self.path_loss_and_grads(rel, rel_inv, comp_w, batch, cfg)
        # The gradients are where this batch's rows become table deltas: a
        # data-parallel step sums them over its ranks.
        g_rel, g_inv = scatter.summed(g_rel), scatter.summed(g_inv)
        if g_w is not None:
            g_w = scatter.summed(g_w)
        out = {
            "entity": projections.ball_norm(ent),
            "relation": projections.ball_norm(rel + d_rel - lr * g_rel),
            "relation_inv": projections.ball_norm(rel_inv - lr * g_inv),
        }
        if comp_w is not None:
            out["comp_w"] = comp_w - lr * g_w
        return out, loss + path_loss

    def sequential_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """Parity mode is the vectorised update (no reference binary exists):
        never TransE's sequential-update kernel."""
        return self.batch_update(params, batch, cfg)

    def warm_start_params(self, params, seed_entity, seed_relation) -> base.Params:
        """Seed from TransE's files (the paper initialises PTransE from
        TransE): entity and relation ball-normed, ``relation_inv`` =
        ball_norm(−relation), the exact inverse under ADD."""
        dev = params["entity"].device
        ent = projections.ball_norm(torch.as_tensor(np.asarray(seed_entity, np.float32), device=dev))
        rel = projections.ball_norm(torch.as_tensor(np.asarray(seed_relation, np.float32), device=dev))
        return {**params, "entity": ent, "relation": rel, "relation_inv": projections.ball_norm(-rel)}


MODEL = base.register(PTransE())
