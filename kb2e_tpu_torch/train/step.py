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
chunk-sized mini-batches instead, as ``kb2e_tpu`` cuts it; on one card their
chunk, which updates in place, is recorded once as a CUDA graph and replayed
for every chunk (:class:`ChunkGraph`).  Given a mesh
(``parallel/mesh.py``), the runner applies each batch through
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
from kb2e_tpu_torch.models.base import CHUNK_KEYS, Batch, Model, Params, pad_to_chunks
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
    and gathers its paths) and then applies them with :meth:`apply`, which tests can also
    feed injected batches.  With ``fused`` (the default for models that
    support it) the batches update one [N+R, k] table
    (``Model.fused_table_update``).  A model with a ``chunk_size`` (TransR, CTransR)
    gets the epoch as mini-batches of ``min(chunk_size, rows)`` instead of
    ``num_batches`` batches: batch boundaries carry no meaning for its
    chunk-sequential update, so the epoch's samples are padded with invalid
    slots to whole chunks and applied chunk by chunk
    (``kb2e_tpu/train/step.py:302-355``).  Returns (params, epoch loss);
    the params it was given are never written.

    On one CUDA device, with no mesh, a model whose chunk runs in place
    (``Model.supports_inplace_chunk``: TransR, CTransR), direct scatters and
    float32 tables, :meth:`apply` replays the chunk as a CUDA graph
    (:class:`ChunkGraph`), captured at its first call and again only when
    what the graph bakes in changes (for CTransR also when a profiler starts
    or stops recording: only a graph captured under one counts).  Everywhere
    else (the CPU, a mesh, ``scatter_mode="dedup"``, whose duplicate merge
    waits for the device) the chunks run eagerly through
    ``Model.batch_update``: the same chunk body.

    With ``mesh`` (``parallel/mesh.py``) the runner is never fused (as in the
    JAX package), the batch must divide by the data axis, the chunk is
    rounded down to a multiple of it, and each batch or chunk goes through
    ``parallel/dist_step.py::distributed_update``; the params it takes and
    returns hold this rank's entity rows.
    """

    def __init__(self, model: Model, cfg: EmbeddingConfig, batch_size: int, num_batches: int,
                 fused: Optional[bool] = None, mesh=None):
        if fused is None:
            fused = mesh is None and model.supports_fused_table
        elif fused and not model.supports_fused_table:
            raise ValueError(f"model {model.name} has no fused-table update")
        elif fused and mesh is not None:
            raise ValueError("the fused-table epoch runner is single-device only")
        d = 1 if mesh is None else mesh.shape["data"]
        if batch_size % d:
            raise ValueError(f"batch_size {batch_size} not divisible by data axis {d}")
        self.model, self.cfg, self.fused, self.mesh = model, cfg, fused, mesh
        self.batch_size, self.num_batches = batch_size, num_batches
        # K > 1 negatives flatten each batch to batch_size*K pair rows.
        self.rows = batch_size * max(1, cfg.num_negatives)
        # Never coarser than the configured batch.
        self.chunk = None if fused else dist_step.chunk_rows(model, self.rows, d)
        self._graph: Optional[ChunkGraph] = None

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
            graph = self._chunk_graph(params, batches)
            if self.chunk is not None:
                profiling.count("train.chunks", n_batches)
                profiling.count("train.chunks_replayed", 0 if graph is None else n_batches)
            if self.mesh is not None:
                return dist_step.apply_batches(self.model, self.cfg, self.mesh, params, batches, n_entities)
            if graph is not None:
                return graph.apply(params, batches)
            losses = []
            if self.fused:
                table = self.model.fuse_params(params)
                for i in range(n_batches):
                    with profiling.span("kb2e.train.batch"):
                        table, loss = self.model.fused_table_update(
                            table, n_entities, {k: v[i] for k, v in batches.items()}, self.cfg
                        )
                    losses.append(loss)
                params = self.model.unfuse_params(table, n_entities)
            else:
                for i in range(n_batches):
                    with profiling.span("kb2e.train.batch"):
                        params, loss = self.model.batch_update(params, {k: v[i] for k, v in batches.items()},
                                                               self.cfg)
                    losses.append(loss)
            return params, torch.stack(losses).sum()

    def _chunk_graph(self, params: Params, batches: Batch) -> Optional[ChunkGraph]:
        """The chunk's CUDA graph where :meth:`apply` can replay one, or None."""
        model, ent, rows = self.model, params["entity"], batches["ph"].shape[1]
        tables = ("entity", "relation", *model.chunk_tables, *model.chunk_inputs)
        if not (self.mesh is None and model.supports_inplace_chunk and self.cfg.scatter_mode == "direct"
                and ent.is_cuda and rows <= model.chunk_size
                and all(params[key].dtype == torch.float32 for key in tables)):
            return None
        counting = bool(model.chunk_counters) and profiling.recording()
        if self._graph is None or self._graph.key != ChunkGraph.key_of(model, params, rows, self.cfg, counting):
            self._graph = None  # the old graph's memory goes before the new one is captured
            self._graph = ChunkGraph(model, self.cfg, params, rows, counting)
        return self._graph

    def __call__(self, params: Params, generator: torch.Generator, data: DeviceData) -> Tuple[Params, torch.Tensor]:
        return self.apply(params, self.sample(generator, data), data.n_entities)


class ChunkGraph:
    """A model's in-place chunk (``Model.chunk_update_``) recorded once as a
    CUDA graph, replayed for every chunk.

    The graph reads and writes buffers of its own at fixed addresses: the
    fused [N+R, k] table and the model's ``chunk_tables`` and
    ``chunk_inputs`` (TransR: ``proj``; CTransR: ``proj``, ``relation_c``
    and the ``centers`` it only reads), a feed [6, chunk] of the chunk's ids
    and ``valid`` (int64) and the chunk's loss.  Warm-up (on a side stream,
    as capture requires) and capture run on these buffers before any
    caller's tables are copied in: of ``params`` the graph takes only the
    shapes and the device.  A graph captured ``counting`` (while a profiler
    records, for a model with ``chunk_counters``) also adds into the
    model's count buffer, which :meth:`apply` reads into the program's
    device counters once a call; any other graph has no kernel of it.
    """

    WARMUP = 2

    @staticmethod
    def key_of(model: Model, params: Params, chunk: int, cfg: EmbeddingConfig, counting: bool):
        """What a graph bakes in: the device, the table shapes, the chunk,
        the update's constants (TF32 picks the products' kernels) and
        whether it counts."""
        shapes = tuple(tuple(params[key].shape) for key in ("entity", "relation", *model.chunk_tables,
                                                             *model.chunk_inputs))
        return (params["entity"].device, shapes, chunk, cfg.distance, cfg.learning_rate, cfg.margin,
                torch.backends.cuda.matmul.allow_tf32, counting)

    def __init__(self, model: Model, cfg: EmbeddingConfig, params: Params, chunk: int, counting: bool = False):
        self.model, self.key = model, self.key_of(model, params, chunk, cfg, counting)
        device, (n_relations, k) = params["entity"].device, params["relation"].shape
        self.n_entities = n_entities = params["entity"].shape[0]
        self.fused = torch.zeros(n_entities + n_relations, k, device=device)
        self.tables = {key: torch.zeros_like(params[key], memory_format=torch.contiguous_format)
                       for key in (*model.chunk_tables, *model.chunk_inputs)}
        self.counts = model.chunk_counts(params) if counting else None
        tables = self.tables if self.counts is None else {**self.tables, "counts": self.counts}
        self.feed = torch.zeros(len(CHUNK_KEYS), chunk, dtype=torch.int64, device=device)

        def body() -> torch.Tensor:
            ids = dict(zip(CHUNK_KEYS, self.feed))
            ids["valid"] = ids["valid"] != 0
            return model.chunk_update_(self.fused, tables, n_entities, ids, cfg)

        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    body()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.loss = body()
        if self.counts is not None:
            self.counts.zero_()  # what warm-up and capture added

    def apply(self, params: Params, batches: Batch) -> Tuple[Params, torch.Tensor]:
        """[n, chunk] chunks in order from ``params``' tables: fresh tables
        (those the chunk only reads are ``params``' own) and the summed
        loss.  A chunk costs the host one copy of its feed, the replay and
        one copy of its loss."""
        n = self.n_entities
        self.fused[:n].copy_(params["entity"])
        self.fused[n:].copy_(params["relation"])
        for key, table in self.tables.items():
            table.copy_(params[key])
        feed = torch.stack([batches[key].to(torch.int64) for key in CHUNK_KEYS], dim=1)
        losses = torch.empty(feed.shape[0], device=self.fused.device)
        for i in range(feed.shape[0]):
            with profiling.span("kb2e.train.batch"):
                self.feed.copy_(feed[i])
                self.graph.replay()
                losses[i].copy_(self.loss)
        if self.counts is not None:
            for name, value in self.model.read_chunk_counts(self.counts).items():
                profiling.count_device(name, value)
            self.counts.zero_()
        fused = self.fused.clone()
        out = {"entity": fused[:n], "relation": fused[n:]}
        out.update({key: self.tables[key].clone() for key in self.model.chunk_tables})
        out.update({key: params[key] for key in self.model.chunk_inputs})
        return out, losses.sum()


def make_epoch_runner(model: Model, cfg: EmbeddingConfig, batch_size: int, num_batches: int,
                      fused: Optional[bool] = None, mesh=None) -> EpochRunner:
    return EpochRunner(model, cfg, batch_size, num_batches, fused=fused, mesh=mesh)
