"""Model protocol and registry (counterpart of ``kb2e_tpu/models/base.py``).

A model is a small stateless class of functions over a params dict of
tensors (``dict[str, torch.Tensor]``).  The contract mirrors the reference's
virtual-hook surface (``common/trainer.h:58-77``):

* ``init_params``        ≙ prepTrain's init + normalise
  (common/trainer.cpp:34-58 plus model extensions)
* ``energy``             ≙ tripleEnergy
* ``project_entities`` / ``relation_vector`` — the evaluation hooks: every
  Trans* model evaluates as a distance sweep in a per-relation projected
  space (see kb2e_tpu_torch/ops/distances.py).

The training hooks (``batch_update``, ``sequential_update``) come with the
training slice.
"""

from __future__ import annotations

import abc
from typing import Dict

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance

Params = Dict[str, torch.Tensor]


class Model(abc.ABC):
    name: str
    # TransH hard-codes L1 and ignores --distance (survey quirk B5).
    uses_distance_flag: bool = True
    # True if evaluation needs a per-relation projection of the entity table.
    needs_projection: bool = False

    @abc.abstractmethod
    def init_params(
        self,
        generator: torch.Generator,
        n_entities: int,
        n_relations: int,
        cfg: EmbeddingConfig,
        device,
    ) -> Params:
        ...

    @abc.abstractmethod
    def energy(
        self, params: Params, h: torch.Tensor, t: torch.Tensor, r: torch.Tensor, distance: Distance
    ) -> torch.Tensor:
        """Batched triple energy, always computed fresh (fixes quirk B1)."""

    # --- evaluation hooks -------------------------------------------------
    def project_entities(self, params: Params, rel: int) -> torch.Tensor:
        """Entity table in relation ``rel``'s scoring space ([N, k])."""
        return params["entity"]

    def relation_vector(self, params: Params, rel: torch.Tensor) -> torch.Tensor:
        return params["relation"][rel]

    def effective_distance(self, distance: Distance) -> Distance:
        return distance if self.uses_distance_flag else Distance.L1


_REGISTRY: Dict[str, Model] = {}


def register(model: Model) -> Model:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> Model:
    # Import lazily so registry population doesn't create import cycles.
    import kb2e_tpu_torch.models.transe  # noqa: F401

    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
