"""TransE: translation scoring E(h, t, r) = dist(t − h − r).

Counterpart of ``kb2e_tpu/models/transe.py``.  Reference semantics:
* energy: transe/transe.cpp:10-28 (L1 = Σ|·|, L2 = Σ(·)² without sqrt).
* init:   randn(0, 1/k, ±6/√k) then ball-norm rows (transe/trainer.cpp:21-23,
          common/trainer.cpp:34-58).

The updates (``batch_update``, ``fused_table_update``, ``sequential_update``)
come with the training slice.
"""

from __future__ import annotations

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base
from kb2e_tpu_torch.ops import distances, projections
from kb2e_tpu_torch.utils import prng

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TransE(base.Model):
    name = "transe"

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


MODEL = base.register(TransE())
