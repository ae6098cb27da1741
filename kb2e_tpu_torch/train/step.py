"""Training steps on one device: sample → score → update.

Counterpart of ``kb2e_tpu/train/step.py``, the recast of the reference's hot
loop ``Trainer::bfgs`` (``common/trainer.cpp:69-107``): a step draws a whole
batch on the device, evaluates both energies, masks by margin violation and
applies the updates.  ``update_mode='parity'`` replays the per-sample
double-buffered semantics instead (``Model.sequential_update``).

Where ``kb2e_tpu`` jit-compiles a step and runs a whole epoch as one
``lax.scan``, the port runs eagerly: the epoch runner samples the whole
epoch in one call, then applies its batches in order in a Python loop.
For the chunk-sequential models (TransR, CTransR) the epoch is cut into
chunk-sized mini-batches instead, as ``kb2e_tpu`` cuts it.  On one device
the model's stepper (``Model.stepper``) decides how each batch or chunk
runs: as hand-written kernels, a replayed CUDA graph or eager ops.  Given a
mesh (``parallel/mesh.py``), the runner applies each batch through
``parallel/dist_step.py``: every rank draws the whole epoch, scores its share
of each batch, and the row deltas are gathered over the data axis.  The
segment launches of the chunked epoch (a workaround for a TPU backend fault)
are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Method
from kb2e_tpu_torch.data.triples import TripleSet
from kb2e_tpu_torch.models.base import Batch, Model, Params, pad_to_chunks
from kb2e_tpu_torch.parallel import dist_step
from kb2e_tpu_torch.sampling import corruption, cuckoo
from kb2e_tpu_torch.utils import profiling


@dataclasses.dataclass
class DeviceData:
    """Training data resident on the device."""

    heads: torch.Tensor
    tails: torch.Tensor
    rels: torch.Tensor
    bern_pr_tail: torch.Tensor  # float32 [R]
    sorted_h: torch.Tensor
    sorted_r: torch.Tensor
    sorted_t: torch.Tensor
    cuckoo_table: Optional[torch.Tensor]  # [2*M, 2], or None (binary-search fallback)
    cuckoo_fp: Optional[torch.Tensor]  # [2*M] fingerprint probe, or None
    cuckoo_m: int
    cuckoo_salt: int
    n_relations: int
    n_entities: int
    # PTransE's path store aligned per triple (None for path-free models).
    paths: Optional[torch.Tensor] = None  # int32 [T, P, L], −1 padded
    path_conf: Optional[torch.Tensor] = None  # float32 [T, P]

    @classmethod
    def from_triple_set(cls, ts: TripleSet, device, path_store=None) -> "DeviceData":
        """Moves ``ts`` to ``device`` with the cuckoo index of its sorted set,
        and ``path_store`` (``data/paths.py::PathStore``, one row per triple
        of ``ts``) when given.

        ``kb2e_tpu`` builds the index in ``TripleSet.from_arrays``; here only
        training pays for the build (592k keys take seconds).
        """
        try:
            idx = cuckoo.build(ts.sorted_h, ts.sorted_r, ts.sorted_t, ts.n_relations)
        except OverflowError:
            idx = None  # binary-search fallback for graphs with N*R >= 2^31

        def put(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype).to(device)

        return cls(
            heads=put(ts.heads),
            tails=put(ts.tails),
            rels=put(ts.rels),
            bern_pr_tail=put(ts.bern_pr_tail, torch.float32),
            sorted_h=put(ts.sorted_h),
            sorted_r=put(ts.sorted_r),
            sorted_t=put(ts.sorted_t),
            cuckoo_table=None if idx is None else put(idx.table),
            cuckoo_fp=None if idx is None else put(idx.fp),
            cuckoo_m=0 if idx is None else idx.m,
            cuckoo_salt=0 if idx is None else idx.salt,
            n_relations=int(ts.n_relations),
            n_entities=int(ts.n_entities),
            paths=None if path_store is None else put(path_store.rels, torch.int32),
            path_conf=None if path_store is None else put(path_store.conf, torch.float32),
        )


def sample_batch(generator: torch.Generator, data: DeviceData, cfg: EmbeddingConfig, batch_size: int) -> Batch:
    """One batch of ``batch_size`` samples from ``data`` under ``cfg``'s sampler
    settings; with a path store, each row's paths, their confidences and a
    corrupted relation as well (:func:`_with_path_data`)."""
    batch = corruption.sample_batch(
        generator,
        data.heads,
        data.tails,
        data.rels,
        data.bern_pr_tail,
        data.sorted_h,
        data.sorted_r,
        data.sorted_t,
        n_entities=data.n_entities,
        batch_size=batch_size,
        method=Method.from_any(cfg.method),
        resample_rounds=cfg.corruption_resample_rounds,
        cuckoo_table=data.cuckoo_table,
        cuckoo_fp=data.cuckoo_fp,
        cuckoo_m=data.cuckoo_m,
        cuckoo_salt=data.cuckoo_salt,
        n_relations=data.n_relations,
        num_negatives=cfg.num_negatives,
        return_idx=data.paths is not None,
    )
    if data.paths is not None:
        batch = _with_path_data(generator, batch, data, cfg.corruption_resample_rounds)
    return batch


def _with_path_data(generator: torch.Generator, batch: Batch, data: DeviceData, resample_rounds: int) -> Batch:
    """``batch`` with PTransE's per-row data, as ``kb2e_tpu/train/step.py::_with_path_data``:
    ``paths`` [B, P, L] and ``conf`` [B, P] of each row's triple (gathered by
    ``idx``, which is dropped), a corrupted relation ``nr`` and its
    ``nr_valid``.  The relation draws follow the batch's on the generator,
    where the JAX package splits a key for them."""
    idx = batch["idx"]
    nr, nr_valid = corruption.sample_relation_negatives(
        generator, batch["ph"], batch["pt"], batch["r"], data.n_relations,
        data.sorted_h, data.sorted_r, data.sorted_t,
        resample_rounds=resample_rounds,
        cuckoo_table=data.cuckoo_table,
        cuckoo_fp=data.cuckoo_fp,
        cuckoo_m=data.cuckoo_m,
        cuckoo_salt=data.cuckoo_salt,
    )
    out = {k: v for k, v in batch.items() if k != "idx"}
    out.update(paths=data.paths[idx], conf=data.path_conf[idx], nr=nr, nr_valid=nr_valid)
    return out


def make_train_step(model: Model, cfg: EmbeddingConfig, batch_size: int):
    """A (params, generator, data) -> (params, loss) step over one sampled batch."""
    parity = cfg.update_mode == "parity"

    def step(params: Params, generator: torch.Generator, data: DeviceData) -> Tuple[Params, torch.Tensor]:
        batch = sample_batch(generator, data, cfg, batch_size)
        if parity:
            return model.sequential_update(params, batch, cfg)
        return model.batch_update(params, batch, cfg)

    return step


def batch_size_for(ts_num_triples: int, num_batches: int) -> int:
    """Reference batch size: |T| / numBatches (common/trainer.cpp:70)."""
    return max(1, ts_num_triples // num_batches)


class EpochRunner:
    """A whole epoch of the fast update, its batches in order.

    ``runner(params, generator, data)`` presamples every batch of the epoch
    in one ``sample_batch`` call (sampling does not depend on the evolving
    tables; with a path store it also draws the epoch's corrupted relations
    and gathers its paths) and then applies them with :meth:`apply`, which
    tests can also feed injected batches.  A model with a ``chunk_size``
    (TransR, CTransR) gets the epoch as mini-batches of
    ``min(chunk_size, rows)`` instead of ``num_batches`` batches: batch
    boundaries carry no meaning for its chunk-sequential update, so the
    epoch's samples are padded with invalid slots to whole chunks and applied
    chunk by chunk (``kb2e_tpu/train/step.py:302-355``).  Returns (params,
    epoch loss); the params it was given are never written.

    On one device :meth:`apply` runs the model's stepper
    (``Model.stepper``), which picks how a step runs: TransE's hand-written
    kernels or its fused plain update, the chunk models' replayed CUDA graph
    or their eager chunk, ``batch_update`` for the others.  The runner keeps
    for the model what outlives an epoch (the captured graph).

    With ``mesh`` (``parallel/mesh.py``) the batch must divide by the data
    axis, the chunk is rounded down to a multiple of it, and each batch or
    chunk goes through ``parallel/dist_step.py::distributed_update``; the
    params it takes and returns hold this rank's entity rows.
    """

    def __init__(self, model: Model, cfg: EmbeddingConfig, batch_size: int, num_batches: int, mesh=None):
        d = 1 if mesh is None else mesh.shape["data"]
        if batch_size % d:
            raise ValueError(f"batch_size {batch_size} not divisible by data axis {d}")
        self.model, self.cfg, self.mesh = model, cfg, mesh
        self.batch_size, self.num_batches = batch_size, num_batches
        # K > 1 negatives flatten each batch to batch_size*K pair rows.
        self.rows = batch_size * max(1, cfg.num_negatives)
        # Never coarser than the configured batch.
        self.chunk = dist_step.chunk_rows(model, self.rows, d)
        self.kept: dict = {}  # the model's, across epochs (Model.stepper)

    def sample(self, generator: torch.Generator, data: DeviceData) -> Batch:
        """Every batch of the epoch, each tensor shaped [num_batches, rows],
        or for a chunked model [n_chunks, chunk] with the padding invalid."""
        with profiling.span("kb2e.train.sample"):
            big = sample_batch(generator, data, self.cfg, self.num_batches * self.batch_size)
            if self.chunk is None:
                return {k: v.reshape(self.num_batches, self.rows, *v.shape[1:]) for k, v in big.items()}
            return pad_to_chunks(big, self.chunk)

    def apply(self, params: Params, batches: Batch, n_entities: int) -> Tuple[Params, torch.Tensor]:
        """Apply [n, rows] batches in order; returns (params, loss sum)."""
        with profiling.span("kb2e.train.apply"):
            n_batches = next(iter(batches.values())).shape[0]
            if self.mesh is not None:
                if self.chunk is not None:  # a mesh replays no graph
                    profiling.count("train.chunks", n_batches)
                    profiling.count("train.chunks_replayed", 0)
                return dist_step.apply_batches(self.model, self.cfg, self.mesh, params, batches, n_entities)
            stepper = self.model.stepper(params, batches, self.cfg, self.kept)
            for i in range(n_batches):
                with profiling.span("kb2e.train.batch"):
                    stepper(i)
            return stepper.params(), stepper.loss.sum()

    def __call__(self, params: Params, generator: torch.Generator, data: DeviceData) -> Tuple[Params, torch.Tensor]:
        return self.apply(params, self.sample(generator, data), data.n_entities)
