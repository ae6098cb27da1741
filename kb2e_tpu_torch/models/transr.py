"""TransR: per-relation matrix projection scoring (counterpart of ``kb2e_tpu/models/transr.py``).

E(h, t, r) = dist( t·W_r − h·W_r − r )  under L1 or L2
(transr/transr.cpp:13-37; the reference's work-vector accumulation bug B1 is
not reproduced: projections are computed fresh).

Params: entity [N,k], relation [R,k], and the projection matrices ``proj``
[R, k, k] laid out [input dim j, output dim i], so a row projects as
``e @ W`` (the reference's ``W[r][j][i]·h[j]`` contraction), all float32.

Reference training semantics reproduced:
* W initialised to identity (transr/trainer.cpp:73-86); entity and relation
  ball-normed ``randn(0, 1/k, ±1)``, or warm-started from TransE seed files
  with the entities sphere-normed (transr/trainer.cpp:88-113,
  :meth:`TransR.warm_start_params`).
* closed-form gradient (transr/trainer.cpp:144-172):
  x = 2(t·W − h·W − r) (L1 → ±1);  W −= β·lr·outer(h−t, x);
  h −= β·lr·(W x);  t += β·lr·(W x);  r −= β·lr·x.
* constraints (transr/trainer.cpp:174-191): sphere-norm the touched e/r rows
  and every row of W_r, then the ‖e·W‖ ≤ 1 projector ``transRNorm`` on
  (h, W), (t, W) and the relation vector (the intent of bug B2).

Fast mode (``batch_update``, plain torch) is chunk-sequential: the batch is
applied ``chunk_size`` samples at a time, each chunk from its own start
snapshot, with one masked iteration of the coupled ‖a·W‖ ≤ 1 descent on the
touched pairs.  A chunk runs in place on a fused [N+R, k] table and W
(``chunk_update_``, whose stages CTransR's chunk shares); on one card the
epoch's chunks run as the hand-written kernel of ``ops/transr_fast.py``
(:meth:`TransR.stepper`), or, for CTransR's chunk, replay it as a CUDA graph
(:class:`ChunkGraph`).  Parity mode
(``sequential_update``) replays the exact per-sample sequence through the
hand-written kernel of ``ops/transr_update.py`` on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base
from kb2e_tpu_torch.ops import distances, projections, scatter, transr_fast, transr_update
from kb2e_tpu_torch.utils import profiling, prng


def _project(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [B, k] times their matrices w [B, k, k]: (row·W)_i."""
    return torch.einsum("bj,bji->bi", rows, w)


# The stages of the in-place chunk that TransR and CTransR share
# (``TransR.chunk_update_``, ``ctransr.CTransR.chunk_update_``).


def scores(w, he, te, ne_h, ne_t, rv, valid, margin: float, dist: Distance):
    """The chunk's residuals t·W − h·W − rv against its start tables:
    (loss, viol, m, x_pos, x_neg), where ``viol`` marks the valid samples
    that violate the margin, ``m`` is it as a [B, 1] float mask and the
    update directions x = 2·res (L1: ±1) are masked by it."""
    res_pos = _project(te, w) - _project(he, w) - rv
    res_neg = _project(ne_t, w) - _project(ne_h, w) - rv
    e_pos = distances.residual_energy(res_pos, dist)
    e_neg = distances.residual_energy(res_neg, dist)
    viol = (e_pos + margin > e_neg) & valid
    loss = torch.sum(torch.where(viol, margin + e_pos - e_neg, 0.0))
    m = viol.to(res_pos.dtype)[:, None]

    def xs(res):
        x = 2.0 * res
        if dist == Distance.L1:
            x = torch.where(x > 0, 1.0, -1.0)
        return x * m

    return loss, viol, m, xs(res_pos), xs(res_neg)


def step_entities_and_w_(ent, proj, chunk: base.Batch, w, he, te, ne_h, ne_t, x_pos, x_neg, lr: float,
                         scatter_mode: str) -> torch.Tensor:
    """The closed-form steps of W and the entity rows, added in place:
    W += lr·(outer(h − t, x_pos) − outer(h′ − t′, x_neg)), h += lr·W x_pos,
    t −= lr·W x_pos, h′ −= lr·W x_neg, t′ += lr·W x_neg (β = −1 positive,
    +1 corrupted; transr/trainer.cpp:147-171).  Returns the entity ids
    [ph, pt, nh, nt] the deltas went to."""
    wx_pos = torch.einsum("bji,bi->bj", w, x_pos)
    wx_neg = torch.einsum("bji,bi->bj", w, x_neg)
    idx = torch.cat([chunk["ph"], chunk["pt"], chunk["nh"], chunk["nt"]])
    d_w = lr * (torch.einsum("bj,bi->bji", he - te, x_pos) - torch.einsum("bj,bi->bji", ne_h - ne_t, x_neg))
    scatter.scatter_add_(proj, chunk["r"], d_w, scatter_mode)
    delta = torch.cat([lr * wx_pos, -lr * wx_pos, -lr * wx_neg, lr * wx_neg])
    scatter.scatter_add_(ent, idx, delta, scatter_mode)
    return idx


def corrupted(chunk: base.Batch) -> torch.Tensor:
    """Each sample's corrupted entity: nh unless nh == ph, then nt."""
    return torch.where(chunk["nh"] != chunk["ph"], chunk["nh"], chunk["nt"])


def ball_step_(fused, proj, ri, viol, lr: float, scatter_mode: str, *groups: torch.Tensor) -> None:
    """One masked iteration of transRNorm, in place, on the pairs (row of
    ``fused``, W_r) that ``groups`` name (one [B] id tensor a group):
    tmp = 2·aW where ‖aW‖² > 1 and the sample violated;
    W −= lr·outer(a, tmp);  a −= lr·(W + ΔW)·tmp.  W is gathered once and
    its deltas are summed across groups and duplicates."""
    size = ri.shape[0]
    pair_a = torch.cat(groups)
    a = fused[pair_a].reshape(len(groups), size, -1)
    w_upd = proj[ri]
    p = torch.einsum("sbj,bji->sbi", a, w_upd)
    act = (torch.sum(p * p, dim=-1, keepdim=True) > 1.0) & viol.repeat(len(groups)).reshape(len(groups), size, 1)
    tmp = torch.where(act, 2.0 * p, 0.0)
    d_w = -lr * torch.einsum("sbj,sbi->bji", a, tmp)
    scatter.scatter_add_(proj, ri, d_w, scatter_mode)
    a_new = a - lr * torch.einsum("bji,sbi->sbj", w_upd + d_w, tmp)
    scatter.scatter_add_(fused, pair_a, (a_new - a).reshape(len(groups) * size, -1), scatter_mode)


class TransR(base.Model):
    name = "transr"
    needs_projection = True
    # The chunk of the fast update, and the mini-batch the epoch runner feeds
    # it (train/step.py); the JAX package's measured optimum.
    chunk_size = 256
    # Whether the one-card fast chunk may run as ``ops/transr_fast.py``'s
    # kernel, which computes TransR's ``chunk_update_``; a model whose chunk
    # differs replays it as a CUDA graph (:class:`ChunkGraph`).
    chunk_kernels = True
    # The params besides ``entity`` and ``relation`` that ``chunk_update_``
    # takes in its ``tables``: those it writes in place, then those it only
    # reads; and the device counters it keeps in a count buffer
    # (``chunk_counts``, given as ``tables["counts"]``) while a profiler
    # records, or none.
    chunk_tables: Tuple[str, ...] = ("proj",)
    chunk_inputs: Tuple[str, ...] = ()
    chunk_counters: Tuple[str, ...] = ()
    weights_key = "proj"  # the matrices, R·k rows of k
    has_warm_start = True

    def weights_shape(self, n_relations, k):
        return (n_relations, k, k)

    def init_params(self, generator, n_entities, n_relations, cfg: EmbeddingConfig, device) -> base.Params:
        k = cfg.embedding_size
        ent = projections.ball_norm(prng.unit_bounded_init(generator, (n_entities, k), k, device))
        rel = projections.ball_norm(prng.unit_bounded_init(generator, (n_relations, k), k, device))
        proj = torch.eye(k, dtype=torch.float32, device=device).expand(n_relations, k, k).contiguous()
        return {"entity": ent, "relation": rel, "proj": proj}

    def energy(self, params, h, t, r, distance: Distance) -> torch.Tensor:
        w = params["proj"][r]
        res = _project(params["entity"][t], w) - _project(params["entity"][h], w) - params["relation"][r]
        return distances.residual_energy(res, distance)

    def project_entities(self, params, rel) -> torch.Tensor:
        # One [N,k]·[k,k] product per relation (the reference's per-relation
        # energy cache, common/evaluation.cpp:194-218).
        return params["entity"] @ params["proj"][rel]

    def _project_all(self, params, e_idx: torch.Tensor, rels: slice) -> torch.Tensor:
        """[B, R′, k]: the rows ``e_idx`` projected by each matrix of ``rels``."""
        return torch.einsum("bj,rji->bri", params["entity"][e_idx], params["proj"][rels])

    def relation_scores(self, params, h, t, rels: slice, distance: Distance) -> torch.Tensor:
        # h and t projected by every W_r′ at once, where the JAX package
        # gathers W per (pair, r′) row (D18); the same tp − hp − r order.
        res = self._project_all(params, t, rels) - self._project_all(params, h, rels) - params["relation"][rels]
        return distances.residual_energy(res, distance)

    def batch_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """Chunk-sequential fast update, as ``kb2e_tpu.models.transr.TransR.batch_update``.

        The batch is padded to whole chunks of ``min(chunk_size, B)`` (pad
        slots index row 0 and are invalid) and applied eagerly chunk by chunk
        (:meth:`eager_chunks`).  Returns (params, loss summed over the
        chunks); ``params`` is not written.
        """
        chunks = base.pad_to_chunks({key: batch[key] for key in base.CHUNK_KEYS},
                                    min(self.chunk_size, batch["ph"].shape[0]))
        steps = self.eager_chunks(params, chunks, cfg)
        for i in range(chunks["ph"].shape[0]):
            steps(i)
        return steps.params(), steps.loss.sum()

    def stepper(self, params, feed: base.Batch, cfg: EmbeddingConfig, kept=None):
        """The fast epoch over ``feed``'s [n, chunk] chunks.  On one CUDA
        device, with direct scatters and float32 tables, the chunks run as
        ``ops/transr_fast.py``'s kernel in place on a fused table and W, where
        the model's ``chunk_kernels`` allows and the kernel takes the tables
        and chunk (:func:`kernels_take`); else a chunk is
        replayed as a CUDA graph (:class:`ChunkGraph`), captured at the
        first call and again only when what it bakes in changes (for CTransR
        also when a profiler starts or stops recording: only a graph
        captured under one counts); ``kept["graph"]`` holds it between
        calls.  Everywhere else (the CPU, ``scatter_mode="dedup"``, whose
        duplicate merge waits for the device) the same chunk runs eagerly
        (:meth:`eager_chunks`)."""
        n, rows = feed["ph"].shape
        keys = ("entity", "relation", *self.chunk_tables, *self.chunk_inputs)
        kernel = self.chunk_kernels and rows <= self.chunk_size and kernels_take(params, rows, cfg)
        replay = (not kernel and cfg.scatter_mode == "direct" and params["entity"].is_cuda
                  and rows <= self.chunk_size and all(params[key].dtype == torch.float32 for key in keys))
        profiling.count("train.chunks", n)
        profiling.count("train.chunks_replayed", n if replay else 0)
        profiling.count("train.chunks_kernel", n if kernel else 0)
        if kernel:
            return self.kernel_chunks(params, feed, cfg)
        if not replay:
            return self.eager_chunks(params, feed, cfg)
        kept = {} if kept is None else kept
        counting = bool(self.chunk_counters) and profiling.recording()
        graph = kept.pop("graph", None)
        if graph is None or graph.key != ChunkGraph.key_of(self, params, rows, cfg, counting):
            graph = None  # the old graph's memory goes before the new one is captured
            graph = ChunkGraph(self, cfg, params, rows, counting)
        kept["graph"] = graph
        return graph.load(params, feed)

    def kernel_chunks(self, params, feed: base.Batch, cfg: EmbeddingConfig) -> transr_fast.FusedChunks:
        """``ops/transr_fast.py``'s kernel over ``feed``'s chunks, in place
        on a fused copy of the entity and relation tables and a copy of W,
        on the card."""
        return transr_fast.FusedChunks(
            base.fuse(params), params["proj"].clone(memory_format=torch.contiguous_format), params["entity"].shape[0],
            feed, learning_rate=cfg.learning_rate, margin=cfg.margin,
            l1=self.effective_distance(Distance.from_any(cfg.distance)) == Distance.L1)

    def eager_chunks(self, params, feed: base.Batch, cfg: EmbeddingConfig) -> base.BatchStepper:
        """:meth:`chunk_update_` a chunk of ``feed``, eagerly, in place on a
        fused copy of the entity and relation tables and copies of the
        ``chunk_tables`` (the ``chunk_inputs`` are ``params``' own)."""
        n_entities = params["entity"].shape[0]
        fused = base.fuse(params)
        tables = {key: params[key].clone(memory_format=torch.contiguous_format) for key in self.chunk_tables}
        tables.update({key: params[key] for key in self.chunk_inputs})
        return base.BatchStepper(lambda _, chunk: (None, self.chunk_update_(fused, tables, n_entities, chunk, cfg)),
                                 None, feed, lambda _: {**base.unfuse(fused, n_entities), **tables})

    def chunk_update_(self, fused: torch.Tensor, tables: base.Params, n_entities: int, chunk: base.Batch,
                      cfg: EmbeddingConfig) -> torch.Tensor:
        """One chunk of the fast update, in place on ``fused`` [N+R, k] (the
        entities, then the relations) and ``tables["proj"]`` [R, k, k];
        returns the chunk's loss.

        Every read of the first stage sees the chunk-start tables and
        duplicate rows' deltas add up:
        * the closed-form gradients of the violating samples, scattered into
          W, the entity and the relation rows (:func:`scores`,
          :func:`step_entities_and_w_`);
        * a sphere norm of every touched row (entities, relations, the rows
          of each touched W) whether or not its sample violated, pad slots
          included;
        * one masked iteration of the coupled ‖a·W‖ ≤ 1 descent on the four
          pair groups (h, r), (t, r), (corrupted, r) and (relation, r)
          (:func:`ball_step_`).
        It waits for the device nowhere, so that it can be recorded as a
        CUDA graph (:class:`ChunkGraph`).
        """
        lr, dist = cfg.learning_rate, self.effective_distance(Distance.from_any(cfg.distance))
        phi, pti, ri, nhi, nti, vi = (chunk[key] for key in base.CHUNK_KEYS)
        proj = tables["proj"]
        ent, rel = fused[:n_entities], fused[n_entities:]

        w = proj[ri]  # the one gather reused by the gradients
        he, te, ne_h, ne_t, rv = ent[phi], ent[pti], ent[nhi], ent[nti], rel[ri]
        loss, viol, _, x_pos, x_neg = scores(w, he, te, ne_h, ne_t, rv, vi, cfg.margin, dist)
        idx = step_entities_and_w_(ent, proj, chunk, w, he, te, ne_h, ne_t, x_pos, x_neg, lr, cfg.scatter_mode)
        scatter.scatter_add_(rel, ri, lr * (x_pos - x_neg), cfg.scatter_mode)

        # Sphere norms of the touched rows; under a data-parallel step, every
        # rank's rows.
        e_rows, r_rows = scatter.touched(idx), scatter.touched(ri)
        for table, rows in ((ent, e_rows), (rel, r_rows), (proj, r_rows)):
            table[rows] = projections.sphere_norm(table[rows])

        ball_step_(fused, proj, ri, viol, lr, cfg.scatter_mode, phi, pti, corrupted(chunk), n_entities + ri)
        return loss

    def sequential_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """The reference's per-sample update of one batch, in float32.

        Goes through ``transr_update.transr_sequential_update``: the
        hand-written kernel for CUDA tensors, its plain version for CPU
        tensors.  ``parity_impl='scan'`` is refused on the card rather than
        run as a per-sample loop there.
        """
        base.check_parity_impl(cfg, params["entity"].device)
        ent, rel, proj, loss, _, _ = transr_update.transr_sequential_update(
            *(params[key].to(torch.float32).contiguous() for key in ("entity", "relation", "proj")),
            batch["ph"], batch["pt"], batch["r"], batch["nh"], batch["nt"], batch["valid"],
            learning_rate=cfg.learning_rate, margin=cfg.margin,
            l1=self.effective_distance(Distance.from_any(cfg.distance)) == Distance.L1,
            max_iters=cfg.projection_max_iters,
        )
        return {"entity": ent, "relation": rel, "proj": proj}, loss

    def warm_start_params(self, params, seed_entity: np.ndarray, seed_relation: np.ndarray) -> base.Params:
        """TransE warm start (transr/trainer.cpp:88-113): the entities are
        loaded and sphere-normed, the relations loaded as they are; W stays
        as it was (identity from ``init_params``)."""
        dev = params["entity"].device
        ent = projections.sphere_norm(torch.as_tensor(np.asarray(seed_entity, np.float32), device=dev))
        rel = torch.as_tensor(np.asarray(seed_relation, np.float32), device=dev)
        return {**params, "entity": ent, "relation": rel}


def kernels_take(params: base.Params, rows: int, cfg: EmbeddingConfig) -> bool:
    """Whether :meth:`TransR.stepper` runs ``ops/transr_fast.py``'s kernel
    for ``params`` and chunks of ``rows`` samples: float32 tables on one CUDA
    device, direct scatters (the kernel adds duplicates one by one, as
    ``index_add`` does), and a width and chunk the kernel takes."""
    ent, rel, proj = params["entity"], params["relation"], params["proj"]
    return (cfg.scatter_mode == "direct" and ent.device.type == "cuda" and rel.device == proj.device == ent.device
            and ent.dtype == rel.dtype == proj.dtype == torch.float32 and transr_fast.takes(ent.shape[1], rows))


class ChunkGraph:
    """A chunk model's in-place chunk (``TransR.chunk_update_``, or
    CTransR's) recorded once as a CUDA graph, replayed for every chunk.

    The graph reads and writes buffers of its own at fixed addresses: the
    fused [N+R, k] table and the model's ``chunk_tables`` and
    ``chunk_inputs`` (TransR: ``proj``; CTransR: ``proj``, ``relation_c``
    and the ``centers`` it only reads), a feed [6, chunk] of the chunk's ids
    and ``valid`` (int64) and the chunk's loss.  Warm-up (on a side stream,
    as capture requires) and capture run on these buffers before any
    caller's tables are copied in: of ``params`` the graph takes only the
    shapes and the device.  A graph captured ``counting`` (while a profiler
    records, for a model with ``chunk_counters``) also adds into the
    model's count buffer, which :meth:`params` reads into the program's
    device counters once an epoch; any other graph has no kernel of it.

    As a stepper (``TransR.stepper``): :meth:`load` an epoch's tables and
    feed, call it with each chunk's index in order, then read ``loss`` [n]
    and ``params()``.
    """

    WARMUP = 2

    @staticmethod
    def key_of(model: TransR, params: base.Params, chunk: int, cfg: EmbeddingConfig, counting: bool):
        """What a graph bakes in: the device, the table shapes, the chunk,
        the update's constants (TF32 picks the products' kernels) and
        whether it counts."""
        shapes = tuple(tuple(params[key].shape) for key in ("entity", "relation", *model.chunk_tables,
                                                             *model.chunk_inputs))
        return (params["entity"].device, shapes, chunk, cfg.distance, cfg.learning_rate, cfg.margin,
                torch.backends.cuda.matmul.allow_tf32, counting)

    def __init__(self, model: TransR, cfg: EmbeddingConfig, params: base.Params, chunk: int, counting: bool = False):
        self.model, self.key = model, self.key_of(model, params, chunk, cfg, counting)
        device, (n_relations, k) = params["entity"].device, params["relation"].shape
        self.n_entities = n_entities = params["entity"].shape[0]
        self.fused = torch.zeros(n_entities + n_relations, k, device=device)
        self.tables = {key: torch.zeros_like(params[key], memory_format=torch.contiguous_format)
                       for key in (*model.chunk_tables, *model.chunk_inputs)}
        self.counts = model.chunk_counts(params) if counting else None
        tables = self.tables if self.counts is None else {**self.tables, "counts": self.counts}
        self.feed = torch.zeros(len(base.CHUNK_KEYS), chunk, dtype=torch.int64, device=device)

        def body() -> torch.Tensor:
            ids = dict(zip(base.CHUNK_KEYS, self.feed))
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
                self.chunk_loss = body()
        if self.counts is not None:
            self.counts.zero_()  # what warm-up and capture added

    def load(self, params: base.Params, feed: base.Batch) -> "ChunkGraph":
        """Copies ``params``' tables into the graph's and readies ``feed``'s
        [n, chunk] chunks; returns the graph."""
        n = self.n_entities
        self.fused[:n].copy_(params["entity"])
        self.fused[n:].copy_(params["relation"])
        for key, table in self.tables.items():
            table.copy_(params[key])
        self.inputs = {key: params[key] for key in self.model.chunk_inputs}
        self.chunks = torch.stack([feed[key].to(torch.int64) for key in base.CHUNK_KEYS], dim=1)
        self.loss = torch.empty(self.chunks.shape[0], device=self.fused.device)
        return self

    def __call__(self, i: int) -> None:
        """Chunk i: one copy of its ids, the replay and one copy of its loss."""
        self.feed.copy_(self.chunks[i])
        self.graph.replay()
        self.loss[i].copy_(self.chunk_loss)

    def params(self) -> base.Params:
        """Fresh tables (those the chunk only reads are the loaded params'
        own); reads and clears the count buffer, and lets the epoch's feed go."""
        self.chunks = None
        if self.counts is not None:
            for name, value in self.model.read_chunk_counts(self.counts).items():
                profiling.count_device(name, value)
            self.counts.zero_()
        out = base.unfuse(self.fused.clone(), self.n_entities)
        out.update({key: self.tables[key].clone() for key in self.model.chunk_tables})
        out.update(self.inputs)
        return out


MODEL = base.register(TransR())
