"""Model protocol and registry (counterpart of ``kb2e_tpu/models/base.py``).

A model is a small stateless class of functions over a params dict of
tensors (``dict[str, torch.Tensor]``).  The contract mirrors the reference's
virtual-hook surface (``common/trainer.h:58-77``):

* ``init_params``        ≙ prepTrain's init + normalise
  (common/trainer.cpp:34-58 plus model extensions)
* ``energy``             ≙ tripleEnergy
* ``batch_update``       ≙ one reference *batch* of gradientUpdate calls,
  vectorised: reads the batch-start snapshot, accumulates all margin-violating
  updates with scatter-adds, then applies the constraint projections once
  (fast mode).
* ``sequential_update``  ≙ the exact double-buffered per-sample semantics
  (transe/trainer.cpp:25-56, transh/trainer.cpp:11-58) — the parity path, a
  hand-written kernel on the card.
* ``project_entities`` / ``relation_vector`` — the evaluation hooks: every
  Trans* model evaluates as a distance sweep in a per-relation projected
  space (see kb2e_tpu_torch/ops/distances.py).
"""

from __future__ import annotations

import abc
from typing import Dict, Tuple

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance

Params = Dict[str, torch.Tensor]

# A sampled training batch (``kb2e_tpu.models.base.Batch``, here a plain
# dict).  Keys, all [B] int32 unless noted: ``ph pt r`` the positive triple,
# ``nh nt`` the corrupted triple (same relation), ``valid`` bool [B] — False
# marks samples whose corruption could not be certified negative within the
# resampling budget; they are masked out of the loss and the update.
Batch = Dict[str, torch.Tensor]

# ``EmbeddingConfig.parity_impl`` values.  Every one reaches the model's
# sequential-update kernel wrapper (its plain version on CPU tensors); the
# port has no scan path, so 'scan' is refused on the card.
PARITY_IMPLS = ("auto", "pallas", "scan")


def check_parity_impl(cfg: EmbeddingConfig, device: torch.device) -> None:
    """Raise for a ``parity_impl`` the port does not run on ``device``."""
    impl = cfg.parity_impl
    if impl not in PARITY_IMPLS:
        raise ValueError(f"parity_impl={impl!r}; expected one of {PARITY_IMPLS}")
    if impl == "scan" and device.type != "cpu":
        raise ValueError("parity_impl='scan' has no port on the card; use 'auto' or 'pallas' (the CUDA kernel)")


class Model(abc.ABC):
    name: str
    # TransH hard-codes L1 and ignores --distance (survey quirk B5).
    uses_distance_flag: bool = True
    # True if evaluation needs a per-relation projection of the entity table.
    needs_projection: bool = False
    # False for models with no reference binary to be faithful to (CTransR,
    # PTransE): their parity mode is the vectorised update.
    has_parity_mode: bool = True
    # True if the fast epoch can run over one fused [N+R, k] table
    # (``fuse_params`` / ``fused_table_update`` / ``unfuse_params``).
    supports_fused_table: bool = False

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

    @abc.abstractmethod
    def batch_update(self, params: Params, batch: Batch, cfg: EmbeddingConfig) -> Tuple[Params, torch.Tensor]:
        """Vectorised margin-ranking SGD step; returns (params, batch loss)."""

    @abc.abstractmethod
    def sequential_update(self, params: Params, batch: Batch, cfg: EmbeddingConfig) -> Tuple[Params, torch.Tensor]:
        """Reference-exact per-sample update of one batch; returns (params, batch loss)."""

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
    import kb2e_tpu_torch.models.transh  # noqa: F401

    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
