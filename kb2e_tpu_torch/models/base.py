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
* ``stepper``            ≙ an epoch of ``batch_update`` on one device, run as
  the model picks: hand-written kernels (TransE), a replayed CUDA graph
  (TransR, CTransR) or eager ops.
* ``sequential_update``  ≙ the exact double-buffered per-sample semantics
  (transe/trainer.cpp:25-56, transh/trainer.cpp:11-58,
  transr/trainer.cpp:118-191) — the parity path, a hand-written kernel on
  the card.
* ``project_entities`` / ``relation_vector`` — the evaluation hooks: every
  Trans* model evaluates as a distance sweep in a per-relation projected
  space (see kb2e_tpu_torch/ops/distances.py); a ``cluster_aware`` model
  (CTransR) routes each candidate to a cluster vector instead.
* ``relation_scores``    — E(h, r′, t) for a range of candidate relations r′
  (relation prediction).
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, Optional, Tuple

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
    # The fast update's chunk for chunk-sequential models (TransR): the
    # epoch runner feeds them the epoch in chunks of this many samples.
    chunk_size: Optional[int] = None
    # The params key of the table in ``weights.<tag>`` (TransH's hyperplane
    # normals, TransR's matrices), or None; its shape is ``weights_shape``.
    weights_key: Optional[str] = None
    # True if training starts from TransE seed files (``warm_start_params``).
    has_warm_start: bool = False
    # True if eval routes each candidate to a per-relation cluster vector
    # (``cluster_vectors`` / ``cluster_centers``, eval/ranking_cluster.py).
    cluster_aware: bool = False
    # True if training and relation prediction read PCRA path stores
    # (``data/paths.py``; PTransE).
    uses_paths: bool = False
    # Tables written beside the reference files as ``<name>.<tag>`` and read
    # back by eval: file name -> params key (skipped where params lack the key).
    file_extras: Dict[str, str] = {}

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

    def relation_scores(self, params: Params, h: torch.Tensor, t: torch.Tensor, rels: slice,
                        distance: Distance) -> torch.Tensor:
        """[B, R′] energies E(h[b], r′, t[b]) for the relations r′ of ``rels``:
        ``energy`` on each (pair, r′) row, pair-major as the JAX package
        repeats them."""
        r = torch.arange(params["relation"].shape[0], device=h.device)[rels]
        n = r.shape[0]
        return self.energy(params, h.repeat_interleave(n), t.repeat_interleave(n), r.repeat(h.shape[0]),
                           distance).reshape(-1, n)

    def effective_distance(self, distance: Distance) -> Distance:
        return distance if self.uses_distance_flag else Distance.L1

    def weights_shape(self, n_relations: int, k: int) -> Optional[Tuple[int, ...]]:
        """Shape of the ``weights_key`` table, as ``weights.<tag>`` holds it."""
        return None

    def warm_start_params(self, params: Params, seed_entity, seed_relation) -> Params:
        """``params`` with the TransE seed tables loaded (``has_warm_start`` models)."""
        raise NotImplementedError(f"model {self.name} has no warm start")

    def stepper(self, params: Params, feed: Batch, cfg: EmbeddingConfig, kept: Optional[dict] = None):
        """The fast update of one device over ``feed``'s [n, rows] batches (a
        chunked model's: chunks), in tables of its own: call it with each
        index in order, then read ``loss`` [n] and ``params()``, the fresh
        tables; ``params`` is never written.  The model picks how its step
        runs.  ``kept`` is a dict its caller keeps across calls for what the
        step may reuse (a captured graph).  Here: ``batch_update`` a batch."""
        return BatchStepper(lambda p, batch: self.batch_update(p, batch, cfg), params, feed)


# The keys of a chunk of the fast update (``Model.chunk_update_``).
CHUNK_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")


def pad_to_chunks(batch: Batch, chunk: int) -> Batch:
    """``batch``'s tensors [B, ...] padded to whole chunks and shaped
    [n_chunks, chunk, ...]; the pad slots hold id 0 and valid = False."""
    pad = -next(iter(batch.values())).shape[0] % chunk
    return {key: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]).reshape(-1, chunk, *v.shape[1:])
            for key, v in batch.items()}


def fuse(params: Params) -> torch.Tensor:
    """A new [N+R, k] table: the entities, then the relations."""
    return torch.cat([params["entity"], params["relation"]])


def unfuse(table: torch.Tensor, n_entities: int) -> Params:
    """``table``'s entity and relation rows, as views."""
    return {"entity": table[:n_entities], "relation": table[n_entities:]}


class BatchStepper:
    """A stepper (``Model.stepper``) that runs ``update(state, batch) ->
    (state, loss)`` eagerly, one call a batch of ``feed``; ``params()`` is
    ``finish(state)``, or the state itself."""

    def __init__(self, update: Callable, state, feed: Batch, finish: Optional[Callable] = None):
        self.update, self.state, self.feed, self.finish, self.losses = update, state, feed, finish, []

    def __call__(self, i: int) -> None:
        self.state, loss = self.update(self.state, {key: v[i] for key, v in self.feed.items()})
        self.losses.append(loss)

    @property
    def loss(self) -> torch.Tensor:
        return torch.stack(self.losses)

    def params(self) -> Params:
        return self.state if self.finish is None else self.finish(self.state)


_REGISTRY: Dict[str, Model] = {}


def register(model: Model) -> Model:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> Model:
    # Import lazily so registry population doesn't create import cycles.
    import kb2e_tpu_torch.models.transe  # noqa: F401
    import kb2e_tpu_torch.models.transh  # noqa: F401
    import kb2e_tpu_torch.models.transr  # noqa: F401
    import kb2e_tpu_torch.models.ctransr  # noqa: F401
    import kb2e_tpu_torch.models.ptranse  # noqa: F401

    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
