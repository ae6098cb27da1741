"""Distributed training steps over a (data, model) mesh (counterpart of ``kb2e_tpu/parallel/dist_step.py``).

The JAX package jits the single-device step under sharding annotations and
GSPMD partitions it.  Here each rank runs the single-device code on its share
and a few collectives make it compute the single-device function:

* Every rank draws the whole batch from an identically seeded generator
  (the sampler is replicated, as the JAX package replicates its data and
  key), and scores its contiguous 1/d of the rows (``data`` axis).
* Where per-row contributions become table deltas (``ops/scatter.py``'s
  ``scatter_add``; PTransE's gradients through ``scatter.summed``), the
  deltas of every rank's rows are gathered in the batch's order and added
  as one device adds them: only the rows the batch touches move, never a
  dense table (TransR's [R, k, k] matrices are 53.8 MB at FB15k's shape).
  The steps after the add (ball norms, TransH's projector, TransR's ball
  iteration) then run on identical tables on every rank.
* Under the ``model`` axis each rank holds a shard of the entity rows, and
  of TransR's and CTransR's per-relation tables (``proj``, ``relation_c``,
  ``centers``) on the relation axis.  The rows the batch touches come from
  their owners (``sharding.owned_rows``), the model updates those compact
  tables with the batch's ids mapped into them, and each owner keeps its
  rows of the result.  The replicated ``relation`` table goes compact
  alongside (TransR indexes ``[entity; relation]`` with one id), and every
  rank writes its rows back.
* Losses are summed over ``data``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.models.base import Batch, Model, Params, pad_to_chunks
from kb2e_tpu_torch.ops import scatter
from kb2e_tpu_torch.parallel import sharding
from kb2e_tpu_torch.parallel.mesh import Mesh
from kb2e_tpu_torch.utils import profiling

# The batch keys that hold entity ids.
ENTITY_KEYS = ("ph", "pt", "nh", "nt")


class RowGather:
    """The data-parallel hook of ``ops/scatter.py``: a rank's share of every
    index and delta tensor is gathered over ``data`` (one ``all_reduce`` of a
    zero-padded [d, ...] buffer) and reordered into the whole batch's order.

    A model builds its index tensors as concatenations of per-sample
    segments ([ph, pt, nh, nt] and the like); each segment is ``share``
    rows per rank, so the gathered [d, segments, share] is transposed to
    [segments, d, share], which is the order one device sees.  An index
    tensor is gathered once a step, however many tables it scatters into.
    """

    def __init__(self, mesh: Mesh, share: int):
        self.mesh, self.share = mesh, share
        self._indices = []  # (the rank's tensor, its gathered whole)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        d = self.mesh.shape["data"]
        m = x.shape[0]
        if m % self.share:
            raise ValueError(f"a scatter of {m} rows is not whole segments of this rank's {self.share}")
        buf = x.new_zeros((d, *x.shape))
        buf[self.mesh.data_index] = x
        self.mesh.all_reduce(buf, "data")
        seg = m // self.share
        return buf.reshape(d, seg, self.share, *x.shape[1:]).transpose(0, 1).reshape(d * m, *x.shape[1:])

    def touched(self, idx: torch.Tensor) -> torch.Tensor:
        for mine, whole in self._indices:
            if mine is idx:
                return whole
        whole = self._gather(idx)
        self._indices.append((idx, whole))
        return whole

    def rows(self, idx: torch.Tensor, delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.touched(idx), self._gather(delta.contiguous())

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x.clone(), "data")


def distributed_update(model: Model, cfg: EmbeddingConfig, mesh: Mesh, params: Params, batch: Batch,
                       n_entities: int) -> Tuple[Params, torch.Tensor]:
    """``model.batch_update`` of the whole ``batch`` (every rank holds it)
    on this rank's share; returns this rank's tables (under the ``model``
    axis its entity shard and its relations of the relation-cut tables) and
    the batch's loss."""
    d = mesh.shape["data"]
    b = next(iter(batch.values())).shape[0]
    if b % d:
        raise ValueError(f"batch of {b} rows not divisible by the data axis {d}")
    share = b // d
    lo = mesh.data_index * share
    local = {k: v[lo:lo + share] for k, v in batch.items()}
    shard = cut = None
    if mesh.shape["model"] > 1:
        shard = params["entity"]
        row0, _ = mesh.entity_rows(n_entities)
        rows = torch.unique(torch.cat([batch[k].reshape(-1) for k in ENTITY_KEYS]).to(torch.int64))
        params = {**params, "entity": sharding.owned_rows(mesh, shard, rows, row0)}
        local.update({k: torch.searchsorted(rows, local[k].to(torch.int64)).to(local[k].dtype)
                      for k in ENTITY_KEYS})
        cut = {key: params[key] for key in sharding.RELATION_KEYS if key in params}
    if cut:
        relation = params["relation"]
        rel0, rel1 = mesh.relation_rows(relation.shape[0])
        rrows = torch.unique(batch["r"].reshape(-1).to(torch.int64))
        params = {**params, "relation": relation[rrows], **sharding.owned_tables(mesh, cut, rrows, rel0)}
        local["r"] = torch.searchsorted(rrows, local["r"].to(torch.int64)).to(local["r"].dtype)
    # One rank on ``data`` holds the whole batch: nothing to gather.
    with scatter.every_rank(RowGather(mesh, share) if d > 1 else None):
        params, loss = model.batch_update(params, local, cfg)
    if shard is not None:
        li = rows - row0
        own = (li >= 0) & (li < shard.shape[0])
        params = {**params, "entity": shard.index_copy(0, li[own], params["entity"][own])}
    if cut:
        li = rrows - rel0
        own = (li >= 0) & (li < rel1 - rel0)
        params = {**params, "relation": relation.index_copy(0, rrows, params["relation"]),
                  **{key: table.index_copy(0, li[own], params[key][own]) for key, table in cut.items()}}
    return params, mesh.all_reduce(loss.detach().clone(), "data")


def apply_batches(model: Model, cfg: EmbeddingConfig, mesh: Mesh, params: Params, batches: Batch,
                  n_entities: int) -> Tuple[Params, torch.Tensor]:
    """[n, rows] batches (or chunks) in order, each by :func:`distributed_update`;
    returns (params, the summed loss)."""
    n = next(iter(batches.values())).shape[0]
    losses = []
    for i in range(n):
        with profiling.span("kb2e.train.batch"):
            params, loss = distributed_update(model, cfg, mesh, params, {k: v[i] for k, v in batches.items()},
                                              n_entities)
        losses.append(loss)
    return params, torch.stack(losses).sum()


def chunk_rows(model: Model, rows: int, data_axis: int):
    """A chunk-sequential model's chunk for batches of ``rows``: never coarser
    than the batch, rounded down to a multiple of the data axis
    (``kb2e_tpu/train/step.py:322-326``); None for other models."""
    if model.chunk_size is None:
        return None
    chunk = min(model.chunk_size, rows)
    return max(data_axis, chunk // data_axis * data_axis)


def make_distributed_train_step(model: Model, cfg: EmbeddingConfig, mesh: Mesh, batch_size: int):
    """A (params, generator, data) -> (params, loss) step over ``mesh``: one
    sampled batch of ``batch_size`` (a multiple of the data axis), cut into
    chunks first for a chunk-sequential model."""
    from kb2e_tpu_torch.train import step as step_lib

    d = mesh.shape["data"]
    if batch_size % d:
        raise ValueError(f"batch_size {batch_size} not divisible by data axis {d}")

    def step(params: Params, generator: torch.Generator, data) -> Tuple[Params, torch.Tensor]:
        batch = step_lib.sample_batch(generator, data, cfg, batch_size)
        chunk = chunk_rows(model, next(iter(batch.values())).shape[0], d)
        batches = {k: v[None] for k, v in batch.items()} if chunk is None else pad_to_chunks(batch, chunk)
        return apply_batches(model, cfg, mesh, params, batches, data.n_entities)

    return step
