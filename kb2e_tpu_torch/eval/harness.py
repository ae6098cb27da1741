"""Link-prediction evaluation harness (counterpart of ``kb2e_tpu/eval/harness.py``).

Reproduces ``EmbeddingEvaluation::run`` (``common/evaluation.cpp:181-251``):
for every test triple, rank the true head and the true tail against all
entities (self included, ranks 1-based — quirk B9), and report raw and
filtered MeanRank and Hits@10 averaged over ``2·|test|`` corruptions.

Where ``kb2e_tpu`` runs the whole eval as one ``lax.scan``, this harness
uploads the query feed to the device once, runs a Python loop over the
batches (each one rank-count kernel launch plus a few small tensor ops), and
fetches all ranks once at the end.

Models that score in a per-relation space (``Model.needs_projection``:
TransH, later TransR) rank their queries in groups, one per relation, as the
JAX harness does: a stable sort by relation, each group padded to whole
batches so that no batch spans two relations.  The JAX harness projects the
entity table inside every scan trip; this one projects it once per group
(``Model.project_entities``) and builds that group's transposed table, and
for L2 its squared norms, once.
Models that score in the raw entity space (TransE) rank all queries as one
group.  A cluster-aware model (CTransR, ``Model.cluster_aware``) ranks the same
groups and batches through the cluster-routed sweep of
``eval/ranking_cluster.py`` instead of the rank-count kernel, with the group's
u = e·ce computed once, where the JAX harness runs scan segments of
``_rank_batch_clustered_body``.

:func:`evaluate_relation_prediction` ranks the true relation of each test
triple among all R candidates (``Model.relation_scores``), with PTransE's
path evidence when given a path store.

Under a mesh (``parallel/mesh.py``; ``rank_all(mesh=...)``, as
``kb2e_tpu/eval/harness.py:429-517``) the entity axis is cut over the
``model`` axis: each rank projects only its rows per group, builds their
aligned transpose (and ‖e‖²), and ranks every batch through
``parallel/eval.py``: the rank count (or CTransR's routed sweep) on its
shard, anchors and energies from their owners, the counts summed.  The
tables cut on the relation axis (TransR's and CTransR's ``proj``,
``relation_c``, ``centers``) stay cut: each group fetches its relation's
rows from their owner, where the JAX package replicates them at the eval's
entry.  Every rank gets the one-rank harness's ranks.  Relation prediction
has no sharded path (in either package) and refuses a mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.data.triples import Dataset
from kb2e_tpu_torch.eval import ranking, ranking_cluster
from kb2e_tpu_torch.models.base import Model, Params
from kb2e_tpu_torch.ops import distances, rank_count
from kb2e_tpu_torch.utils.device import resolve_device


class _FilterIndex:
    """Sorted (anchor, relation) → candidate-entity index over the filter set.

    One stable argsort over packed keys stands in for the reference's
    known-good map build (common/evaluation.cpp:55-61).  Duplicate triples are
    KEPT, in input order — the reference's vector push_back keeps them too and
    the filtered correction counts per list element."""

    def __init__(self, anchors: np.ndarray, rels: np.ndarray, values: np.ndarray, n_relations: int):
        self._n_relations = int(n_relations)
        keys = anchors.astype(np.int64) * self._n_relations + rels.astype(np.int64)
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._values = values.astype(np.int32)[order]

    def lookup(self, anchors: np.ndarray, rels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query [lo, hi) segment bounds into the sorted value array."""
        q = anchors.astype(np.int64) * self._n_relations + rels.astype(np.int64)
        return (
            np.searchsorted(self._keys, q, side="left"),
            np.searchsorted(self._keys, q, side="right"),
        )

    @property
    def values(self) -> np.ndarray:
        """The sorted candidate array `lookup` bounds index into."""
        return self._values


def _round_up_pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


class EvalAccumulator:
    """Accumulates the reference's four counters (common/evaluation.cpp:188-192)
    plus the standard extended KGE metrics (MRR, Hits@1/3)."""

    _HITS_KS = (1, 3, 10)

    def __init__(self):
        self.raw_sum_rank = 0
        self.filtered_sum_rank = 0
        self.raw_sum_recip = 0.0
        self.filtered_sum_recip = 0.0
        self.raw_hits = {k: 0 for k in self._HITS_KS}
        self.filtered_hits = {k: 0 for k in self._HITS_KS}
        self.n = 0

    def add(self, raw_ranks: np.ndarray, filtered_ranks: np.ndarray) -> None:
        self.raw_sum_rank += int(raw_ranks.sum())
        self.filtered_sum_rank += int(filtered_ranks.sum())
        self.raw_sum_recip += float((1.0 / raw_ranks.astype(np.float64)).sum())
        self.filtered_sum_recip += float((1.0 / filtered_ranks.astype(np.float64)).sum())
        for k in self._HITS_KS:
            self.raw_hits[k] += int((raw_ranks <= k).sum())
            self.filtered_hits[k] += int((filtered_ranks <= k).sum())
        self.n += int(raw_ranks.shape[0])

    def metrics(self) -> Dict[str, float]:
        n = max(self.n, 1)
        out = {
            "raw_mean_rank": self.raw_sum_rank / n,
            "filtered_mean_rank": self.filtered_sum_rank / n,
            "raw_hits10": self.raw_hits[10] / n,
            "filtered_hits10": self.filtered_hits[10] / n,
            "raw_mrr": self.raw_sum_recip / n,
            "filtered_mrr": self.filtered_sum_recip / n,
            "num_corruptions": self.n,
        }
        for k in self._HITS_KS[:-1]:
            out[f"raw_hits{k}"] = self.raw_hits[k] / n
            out[f"filtered_hits{k}"] = self.filtered_hits[k] / n
        return out


def _eval_inputs(params: Params, dataset: Dataset, test_triples, dev: torch.device):
    """The tables as float32 on ``dev`` (low-precision training tables are
    upcast once; every sweep scores in float32), the test triples as int64
    (the dataset's test split unless given), and the filter set's parts:
    train, valid and test (common/evaluation.cpp:55-61)."""
    if test_triples is None:
        test_triples = dataset.test
    if test_triples is None or test_triples[0].size == 0:
        raise ValueError("no test triples to evaluate")
    params = {k: v.to(device=dev, dtype=torch.float32) if v.is_floating_point() else v.to(dev)
              for k, v in params.items()}
    parts = [(dataset.train.heads, dataset.train.tails, dataset.train.rels)]
    parts += [split for split in (dataset.valid, test_triples) if split is not None]
    return params, tuple(np.asarray(a, dtype=np.int64) for a in test_triples), parts


def rank_all(
    model: Model,
    params: Params,
    dataset: Dataset,
    cfg: EmbeddingConfig,
    *,
    test_triples: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    device="cuda",
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(raw, filtered) int32 ranks of every query in the harness's order, and
    the size of each batch in that order.

    The queries are, per test triple, corrupt-head then corrupt-tail
    (common/evaluation.cpp:230-238).  For a model without projection that is
    the harness's order; a model with one ranks them grouped by relation
    (a stable sort of the query list by relation id).  A cluster-aware model
    ranks through the cluster-routed sweep (no rank-count launch).  With
    ``mesh`` each rank sweeps its entity rows on the mesh's device;
    ``params["entity"]`` may be the full table or this rank's rows, and so
    may each relation-cut table (its ``relation_rows``).
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    if cfg.eval_impl not in ("auto", "pallas"):
        raise ValueError(
            f"eval_impl={cfg.eval_impl!r}: the port has one ranking sweep, the rank-count "
            "kernel; use 'auto' (or 'pallas')"
        )
    params, (th, tt, tr), parts = _eval_inputs(params, dataset, test_triples, dev)
    fh, ft, fr = (np.concatenate([np.asarray(p[i]) for p in parts]) for i in range(3))
    # (h, r) → known tails and (t, r) → known heads.
    tails_of_hr = _FilterIndex(fh, fr, ft, dataset.n_relations)
    heads_of_tr = _FilterIndex(ft, fr, fh, dataset.n_relations)

    distance = model.effective_distance(Distance.from_any(cfg.distance))
    block_size = cfg.eval_block_size
    batch_size = cfg.eval_batch_size

    # The query list: per test triple, corrupt-head then corrupt-tail.
    # corrupt-head: q = proj[t] − r, true = h, filters = heads of (t, r).
    # corrupt-tail: q = proj[h] + r, true = t, filters = tails of (h, r).
    n_test = th.shape[0]
    n_query = 2 * n_test
    q_rel = np.repeat(tr, 2)
    q_anchor = np.empty(n_query, dtype=np.int64)
    q_anchor[0::2], q_anchor[1::2] = tt, th
    q_sign = np.empty(n_query, dtype=np.float32)
    q_sign[0::2], q_sign[1::2] = -1.0, 1.0
    q_true = np.empty(n_query, dtype=np.int64)
    q_true[0::2], q_true[1::2] = th, tt
    # Filter-list segment bounds; odd slots index the tails partition, which
    # follows the heads partition in the flat candidate array.
    q_lo = np.empty(n_query, dtype=np.int64)
    q_hi = np.empty(n_query, dtype=np.int64)
    q_lo[0::2], q_hi[0::2] = heads_of_tr.lookup(tt, tr)
    q_lo[1::2], q_hi[1::2] = tails_of_hr.lookup(th, tr)
    q_count = q_hi - q_lo
    q_lo[1::2] += heads_of_tr.values.shape[0]
    filt_vals = np.concatenate([heads_of_tr.values, tails_of_hr.values])

    # Query groups: one per relation for a projecting model (a stable sort,
    # one unique pass), else one group of every query.
    if model.needs_projection:
        order = np.argsort(q_rel, kind="stable")
        uniq, starts = np.unique(q_rel[order], return_index=True)
        bounds = np.append(starts, n_query)
        groups = [(int(uniq[g]), order[bounds[g] : bounds[g + 1]]) for g in range(uniq.shape[0])]
    else:
        groups = [(None, np.arange(n_query))]

    # The feed holds the groups in order, each padded to whole batches; pad
    # slots rank query 0 and are dropped after the fetch.
    sel_parts = []
    for _, idxs in groups:
        n_slot = -(-idxs.shape[0] // batch_size) * batch_size
        sel_parts.append(np.concatenate([idxs, np.full(n_slot - idxs.shape[0], -1)]))
    feed_sel = np.concatenate(sel_parts)
    real = feed_sel >= 0
    sizes = [min(batch_size, idxs.shape[0] - s) for _, idxs in groups for s in range(0, idxs.shape[0], batch_size)]

    def upload(a: np.ndarray, dtype) -> torch.Tensor:
        out = np.zeros(feed_sel.shape[0], dtype=dtype)
        out[real] = a[feed_sel[real]]
        return torch.from_numpy(out).to(dev)

    feed = dict(
        q_anchor=upload(q_anchor, np.int32),
        q_sign=upload(q_sign, np.float32),
        q_rel=upload(q_rel, np.int32),
        q_true=upload(q_true, np.int32),
        q_lo=upload(q_lo, np.int32),
        q_count=upload(q_count, np.int32),
        filt_vals=torch.from_numpy(filt_vals.astype(np.int32)).to(dev),
    )
    # One candidate width for the whole eval, as the JAX harness compiles once.
    kmax = _round_up_pow2(int(q_count.max(initial=1)))

    row0, cut = 0, {}
    if mesh is not None:
        from kb2e_tpu_torch.parallel import eval as par_eval
        from kb2e_tpu_torch.parallel import sharding

        row0, _ = mesh.entity_rows(dataset.n_entities)
        params = {**params, "entity": sharding.local_rows(mesh, params["entity"], dataset.n_entities)}
        # The relation-cut tables stay cut: each group fetches its rows.
        cut = {key: sharding.local_relations(mesh, params[key], dataset.n_relations)
               for key in sharding.RELATION_KEYS if key in params}
        rel0, _ = mesh.relation_rows(dataset.n_relations)

    def group_tables(rel_id):
        """(tables, index) of relation ``rel_id``'s group: under a mesh its
        rows of the relation-cut tables from their owner, as one-row tables
        at index 0 (the same bits as the whole table's rows)."""
        if not cut or rel_id is None:
            return params, rel_id
        rid = torch.tensor([rel_id], device=dev)
        return {**params, **sharding.owned_tables(mesh, cut, rid, rel0)}, 0

    raws = torch.empty((feed_sel.shape[0] // batch_size, batch_size), dtype=torch.int32, device=dev)
    filts = torch.empty_like(raws)
    i = 0
    for rel_id, idxs in groups:
        tables, rel = group_tables(rel_id)
        proj = params["entity"] if rel_id is None else model.project_entities(tables, rel)
        if model.cluster_aware:
            # The group's projection and u = e·ce, once; routed batches.
            ent = params["entity"]
            vecs, centers = model.cluster_vectors(tables, rel), model.cluster_centers(tables, rel)
            u = ent @ centers.T
            for _ in range(0, idxs.shape[0], batch_size):
                sl = slice(i * batch_size, (i + 1) * batch_size)
                anchor = feed["q_anchor"][sl].to(torch.int64)
                cands = ranking.feed_candidates(feed["q_lo"][sl], feed["q_count"][sl], feed["filt_vals"], kmax)
                if mesh is None:
                    raws[i], filts[i] = ranking_cluster.rank_queries_clustered(
                        proj, ent, proj[anchor], ent[anchor], feed["q_sign"][sl], vecs, centers,
                        feed["q_true"][sl], cands, distance, block_size, u=u,
                    )
                else:
                    raws[i], filts[i] = par_eval.rank_queries_clustered_sharded(
                        mesh, proj, ent, row0, anchor, feed["q_sign"][sl], vecs, centers, feed["q_true"][sl],
                        cands, distance, block_size, u,
                    )
                i += 1
            continue
        # The group's table, projected once, that table transposed in the
        # rank count's aligned layout, and for L2 its squared norms.
        proj_t = rank_count.aligned_transpose(proj)
        e_sq = None
        if distance == Distance.L2:
            e_sq = (distances.squared_norms(proj_t) if mesh is None
                    else par_eval.shard_squared_norms(proj_t, row0, dataset.n_entities))
        for _ in range(0, idxs.shape[0], batch_size):
            knobs = dict(start=i * batch_size, distance=distance, block_size=block_size, batch=batch_size,
                         kmax=kmax, e_sq=e_sq)
            if mesh is None:
                raws[i], filts[i] = ranking.rank_feed_queries(proj, proj_t, params["relation"], **feed, **knobs)
            else:
                raws[i], filts[i] = par_eval.rank_feed_queries_sharded(
                    mesh, proj, proj_t, row0, params["relation"], **feed, **knobs)
            i += 1
    return raws.reshape(-1).cpu().numpy()[real], filts.reshape(-1).cpu().numpy()[real], sizes


def evaluate(
    model: Model,
    params: Params,
    dataset: Dataset,
    cfg: EmbeddingConfig,
    *,
    test_triples: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    verbose: bool = False,
    device="cuda",
    mesh=None,
) -> Dict[str, float]:
    """Run filtered/raw link prediction on ``device`` (or over ``mesh``'s
    ranks, the entity axis cut over its model axis); returns the metrics."""
    raw, filt, sizes = rank_all(model, params, dataset, cfg, test_triples=test_triples, device=device, mesh=mesh)
    if verbose:
        print(f"\rProcessed {100.0:05.2f}% ...")
    return metrics_from_ranks(raw, filt, sizes)


# Relation prediction scores R′ candidate relations at a time, with R′ cut so
# that a [B, R′, k] float32 temporary ([B, P, R′, k] with path evidence)
# stays within this many bytes.
RELATION_SLICE_BYTES = 1 << 30
NO_SHARDED_RELATION_TASK = ("relation prediction (--task relation) has no sharded path, in this package or in "
                            "kb2e_tpu: run it on one device, without --data-axis/--model-axis")


def relation_ranks(
    model: Model,
    params: Params,
    dataset: Dataset,
    cfg: EmbeddingConfig,
    *,
    test_triples: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    path_store=None,
    device="cuda",
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(raw, filtered) int32 ranks of each test triple's relation among all R,
    and the batch sizes, as ``kb2e_tpu/eval/harness.py::evaluate_relation_prediction``
    ranks them.

    Scores are E(h, r′, t) (``Model.relation_scores``), in batches of
    ``eval_batch_size`` triples.  With ``path_store`` (``data/paths.py::PathStore``
    rows aligned to the test triples, extracted over the train graph) and a
    ``relation_inv`` table in ``params`` (PTransE), each candidate's score
    adds the path evidence Σ_p conf(p)·‖comp(p) − r′‖₁: the energy first,
    then the sum over k of a [B, P, R′, k] difference, then over P, in the
    JAX package's order; R′ is sliced so that this temporary stays within
    ``RELATION_SLICE_BYTES``.  Raw rank = 1 + #{r′ : s_r′ < s_true or
    (s_r′ = s_true and r′ < true)}; the filtered rank subtracts the other
    relations known to hold for (h, t) in train ∪ valid ∪ test (set
    semantics: one ``np.unique`` over packed (h·N + t)·R + r keys) that beat
    the true one.  Ranks stay on the device until one fetch at the end.
    ``mesh`` raises: relation prediction has no sharded path.
    """
    if mesh is not None:
        raise NotImplementedError(NO_SHARDED_RELATION_TASK)
    dev = resolve_device(device)
    params, (th, tt, tr), parts = _eval_inputs(params, dataset, test_triples, dev)
    n_test, n_rel, n_ent = th.shape[0], dataset.n_relations, dataset.n_entities
    distance = model.effective_distance(Distance.from_any(cfg.distance))
    packed = np.unique(np.concatenate(
        [(np.asarray(p[0], np.int64) * n_ent + np.asarray(p[1], np.int64)) * n_rel + np.asarray(p[2], np.int64)
         for p in parts]))
    pair_keys, pair_rels = packed // n_rel, packed % n_rel
    # Every test pair's known relations but its own, -1 padded.
    key = th * n_ent + tt
    lo, hi = np.searchsorted(pair_keys, key, side="left"), np.searchsorted(pair_keys, key, side="right")
    pos = lo[:, None] + np.arange(int((hi - lo).max(initial=1)))[None, :]
    valid = pos < hi[:, None]
    cands = np.where(valid, pair_rels[np.minimum(pos, pair_rels.shape[0] - 1)], -1)
    cands[cands == tr[:, None]] = -1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    h_all, t_all, r_all, cands_all = put(th), put(tt), put(tr), put(cands)
    batch = cfg.eval_batch_size
    k = params["entity"].shape[1]
    use_paths = path_store is not None and "relation_inv" in params
    n_paths = 1
    if use_paths:
        from kb2e_tpu_torch.models import ptranse

        paths_all, conf_all = put(path_store.rels), put(path_store.conf)
        rel_all = torch.cat([params["relation"], params["relation_inv"]])
        n_paths = paths_all.shape[1]
    step = max(1, RELATION_SLICE_BYTES // (4 * batch * k * n_paths))
    rel_ids = torch.arange(n_rel, device=dev)[None, :]
    raw = torch.empty(n_test, dtype=torch.int32, device=dev)
    filt = torch.empty_like(raw)

    def score(h, t, rels: slice, pv, conf):
        e = model.relation_scores(params, h, t, rels, distance)
        if pv is None:
            return e
        d = (pv[:, :, None, :] - params["relation"][None, None, rels]).abs_().sum(-1)  # [B, P, R′]
        return e + (conf[:, :, None] * d).sum(dim=1)

    for s in range(0, n_test, batch):
        sl = slice(s, s + batch)
        h, t, true = h_all[sl], t_all[sl], r_all[sl][:, None]
        pv = conf = None
        if use_paths:
            pv = ptranse.compose_paths(rel_all, paths_all[sl], cfg.path_composition, params.get("comp_w"))
            conf = conf_all[sl]
        scores = torch.cat([score(h, t, slice(r0, r0 + step), pv, conf) for r0 in range(0, n_rel, step)], dim=1)
        s_true = torch.gather(scores, 1, true)
        beat = (scores < s_true) | ((scores == s_true) & (rel_ids < true))
        raw[sl] = 1 + torch.sum(beat, dim=1, dtype=torch.int32)
        c = cands_all[sl]
        sub = torch.gather(beat, 1, torch.clamp(c, min=0)) & (c >= 0)
        filt[sl] = raw[sl] - torch.sum(sub, dim=1, dtype=torch.int32)
    sizes = [min(batch, n_test - s) for s in range(0, n_test, batch)]
    return raw.cpu().numpy(), filt.cpu().numpy(), sizes


def evaluate_relation_prediction(
    model: Model,
    params: Params,
    dataset: Dataset,
    cfg: EmbeddingConfig,
    *,
    test_triples: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    path_store=None,
    verbose: bool = False,
    device="cuda",
    mesh=None,
) -> Dict[str, float]:
    """Relation prediction on ``device`` (the PTransE paper's second task;
    the reference has none), with PTransE's path evidence when
    ``path_store`` is given; returns the metrics, Hits@1 among them."""
    raw, filt, sizes = relation_ranks(model, params, dataset, cfg, test_triples=test_triples, path_store=path_store,
                                      device=device, mesh=mesh)
    if verbose:
        print(f"\rRelation prediction {100.0:05.2f}% ...")
    return metrics_from_ranks(raw, filt, sizes)


def metrics_from_ranks(raw: np.ndarray, filt: np.ndarray, sizes: List[int]) -> Dict[str, float]:
    """The metrics of ``rank_all``'s ranks, added batch by batch in the
    harness's order, as kb2e_tpu adds them, so the float sums agree bit for
    bit."""
    acc, start = EvalAccumulator(), 0
    for b in sizes:
        acc.add(raw[start : start + b], filt[start : start + b])
        start += b
    return acc.metrics()


def print_reference_style(metrics: Dict[str, float]) -> None:
    """Print the reference's final two lines (common/evaluation.cpp:247-250)."""
    print(
        f"Raw      -- Rank: {metrics['raw_mean_rank']:f}, "
        f"Hits@10: {metrics['raw_hits10']:f}"
    )
    print(
        f"Filtered -- Rank: {metrics['filtered_mean_rank']:f}, "
        f"Hits@10: {metrics['filtered_hits10']:f}"
    )


def print_extended(metrics: Dict[str, float]) -> None:
    """Extended metrics beyond the reference's surface (MRR, Hits@1/3),
    printed after the two reference-format lines."""
    for label, pre in (("Raw", "raw"), ("Filtered", "filtered")):
        print(
            f"{label} extended -- MRR: {metrics[f'{pre}_mrr']:.6f}, "
            f"Hits@1: {metrics[f'{pre}_hits1']:.6f}, "
            f"Hits@3: {metrics[f'{pre}_hits3']:.6f}"
        )
