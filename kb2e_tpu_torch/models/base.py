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
from typing import Dict, Optional, Tuple

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
    # The fast update's chunk for chunk-sequential models (TransR): the
    # epoch runner feeds them the epoch in chunks of this many samples.
    chunk_size: Optional[int] = None
    # True if the fast update is ``chunk_update_`` applied chunk by chunk in
    # place on a fused [N+R, k] table and the ``chunk_tables``, which waits
    # for the device nowhere: on one card the epoch runner replays it as a
    # CUDA graph.
    supports_inplace_chunk: bool = False
    # The params besides ``entity`` and ``relation`` that ``chunk_update_``
    # takes in its ``tables``: those it writes in place, then those it only
    # reads.
    chunk_tables: Tuple[str, ...] = ()
    chunk_inputs: Tuple[str, ...] = ()
    # The device counters that ``chunk_update_`` keeps in a count buffer
    # (``chunk_counts``, given as ``tables["counts"]``) while a profiler
    # records, or none.
    chunk_counters: Tuple[str, ...] = ()
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

    def chunk_counts(self, params: Params) -> torch.Tensor:
        """A zeroed count buffer for ``chunk_update_`` (models with ``chunk_counters``)."""
        raise NotImplementedError(f"model {self.name} counts nothing in its chunk")

    def read_chunk_counts(self, counts: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each of ``chunk_counters`` as a device scalar, from ``counts``."""
        raise NotImplementedError(f"model {self.name} counts nothing in its chunk")


# The keys of a chunk of the fast update (``Model.chunk_update_``).
CHUNK_KEYS = ("ph", "pt", "r", "nh", "nt", "valid")


def pad_to_chunks(batch: Batch, chunk: int) -> Batch:
    """``batch``'s tensors [B, ...] padded to whole chunks and shaped
    [n_chunks, chunk, ...]; the pad slots hold id 0 and valid = False."""
    pad = -next(iter(batch.values())).shape[0] % chunk
    return {key: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]).reshape(-1, chunk, *v.shape[1:])
            for key, v in batch.items()}


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
