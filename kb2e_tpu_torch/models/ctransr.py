"""CTransR: cluster-based TransR (counterpart of ``kb2e_tpu/models/ctransr.py``).

Lin et al., AAAI'15, §"CTransR": the triples of each relation are clustered
by their seed-embedding offsets t − h; each cluster c of relation r gets its
own vector r_{r,c}, which shares the relation's matrix W_r, and training adds
the regulariser α·‖r_{r,c} − r‖², which keeps the cluster vectors near the
relation vector r.  The reference ships no CTransR code, so the JAX package
is the definition this port follows.

Params: entity [N,k], relation [R,k], relation_c [R,C,k], proj [R,k,k] and
centers [R,C,k], the k-means centers of the seed offsets, which only route
triples to clusters and are never trained.

A triple (h, t, r) takes the cluster whose center is nearest its offset
e_t − e_h by the squared distance ‖o − ce_c‖² (``argmin`` keeps the first
minimum, as ``jnp.argmin`` does).  Eval routes each candidate entity the same
way through the expansion −2s·u + 2s·v + ‖ce‖² (``eval/ranking_cluster.py``).

Kept from the JAX package as it is: the warm start loads the TransE tables
into ``entity`` and ``relation`` only, so ``relation_c`` stays the broadcast
of the random init's relation table (``init_params``); ``centers`` come from
``build_centers`` on the warm-started entities (``cli/train.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.models import base, transr
from kb2e_tpu_torch.ops import distances, projections, scatter

DEFAULT_NUM_CLUSTERS = 4
DEFAULT_ALPHA = 1.0


def kmeans_offsets(offsets: np.ndarray, n_clusters: int, n_iters: int = 25, seed: int = 0) -> np.ndarray:
    """Plain k-means over offset vectors; returns [n_clusters, k] centers.

    Degenerate relations (fewer offsets than clusters) fill the missing
    centers with their mean so every cluster id stays valid; a relation with
    no offsets gets zero centers.
    """
    rng = np.random.default_rng(seed)
    n = offsets.shape[0]
    if n == 0:
        return np.zeros((n_clusters, offsets.shape[1]), dtype=np.float32)
    init_idx = rng.choice(n, size=min(n_clusters, n), replace=False)
    centers = offsets[init_idx].copy()
    if centers.shape[0] < n_clusters:
        centers = np.concatenate(
            [centers, np.repeat(offsets.mean(0, keepdims=True), n_clusters - centers.shape[0], 0)]
        )
    for _ in range(n_iters):
        d = np.linalg.norm(offsets[:, None, :] - centers[None, :, :], axis=-1)
        assign = d.argmin(1)
        for c in range(n_clusters):
            mask = assign == c
            if mask.any():
                centers[c] = offsets[mask].mean(0)
    return centers.astype(np.float32)


def build_centers(
    seed_entity: np.ndarray,
    heads: np.ndarray,
    tails: np.ndarray,
    rels: np.ndarray,
    n_relations: int,
    n_clusters: int = DEFAULT_NUM_CLUSTERS,
    seed: int = 0,
) -> np.ndarray:
    """Per-relation k-means centers of the seed offsets t − h; [R, C, k].

    Relation r's k-means runs on its triples' offsets in file order, seeded
    with ``seed + r``.  The triples are grouped by one stable sort where the
    JAX package masks the whole set once per relation: the same rows in the
    same order, so the same centers.
    """
    k = seed_entity.shape[1]
    centers = np.zeros((n_relations, n_clusters, k), dtype=np.float32)
    offsets_all = seed_entity[tails] - seed_entity[heads]
    order = np.argsort(rels, kind="stable")
    bounds = np.searchsorted(rels[order], np.arange(n_relations + 1))
    for r in range(n_relations):
        centers[r] = kmeans_offsets(offsets_all[order[bounds[r] : bounds[r + 1]]], n_clusters, seed=seed + r)
    return centers


def assign_clusters(
    seed_entity: np.ndarray, centers: np.ndarray, heads: np.ndarray, tails: np.ndarray, rels: np.ndarray
) -> np.ndarray:
    """Host-side nearest-center cluster id per triple; int32 [T]."""
    offsets = seed_entity[tails] - seed_entity[heads]
    d = np.linalg.norm(offsets[:, None, :] - centers[rels], axis=-1)
    return d.argmin(1).astype(np.int32)


def assign_clusters_device(
    entity: torch.Tensor, centers_r: torch.Tensor, h: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """Assignment against one relation's centers [C, k], on the tables' device."""
    return _nearest(entity[t] - entity[h], centers_r[None])


def _nearest(offsets: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """int32 [B]: the first c minimising ‖offsets[b] − centers[b, c]‖² (centers
    [B or 1, C, k])."""
    d = torch.sum(torch.square(offsets[:, None, :] - centers), dim=-1)
    return torch.argmin(d, dim=1).to(torch.int32)


class CTransR(transr.TransR):
    name = "ctransr"
    # Eval routes every candidate to a cluster (eval/ranking_cluster.py).
    cluster_aware = True
    # No reference binary to be sequentially faithful to: parity mode is the
    # fast update, and K5 (TransR's kernel) never sees a CTransR batch.
    has_parity_mode = False
    file_extras = {"relation_clusters": "relation_c", "cluster_centers": "centers"}

    def __init__(self, n_clusters: int = DEFAULT_NUM_CLUSTERS, alpha: float = DEFAULT_ALPHA):
        self.n_clusters = n_clusters
        self.alpha = alpha

    def init_params(self, generator, n_entities, n_relations, cfg: EmbeddingConfig, device) -> base.Params:
        params = super().init_params(generator, n_entities, n_relations, cfg, device)
        k = cfg.embedding_size
        rel_c = params["relation"][:, None, :].expand(n_relations, self.n_clusters, k).contiguous()
        centers = torch.zeros((n_relations, self.n_clusters, k), dtype=torch.float32, device=device)
        return {**params, "relation_c": rel_c, "centers": centers}

    def with_centers(self, params: base.Params, centers: np.ndarray) -> base.Params:
        dev = params["entity"].device
        return {**params, "centers": torch.as_tensor(np.asarray(centers, np.float32), device=dev)}

    def _cluster_ids(self, params, h, t, r) -> torch.Tensor:
        """Nearest-center cluster of each triple (mixed relations)."""
        return _nearest(params["entity"][t] - params["entity"][h], params["centers"][r])

    def energy(self, params, h, t, r, distance: Distance) -> torch.Tensor:
        c = self._cluster_ids(params, h, t, r)
        w = params["proj"][r]
        res = transr._project(params["entity"][t], w) - transr._project(params["entity"][h], w) \
            - params["relation_c"][r, c]
        return distances.residual_energy(res, distance)

    def relation_scores(self, params, h, t, rels: slice, distance: Distance) -> torch.Tensor:
        """[B, R′] energies with the relations ``rels``, each pair routed to
        the cluster of r′ nearest its offset by the direct squared distance,
        as ``energy`` routes it; one cluster at a time, so the largest
        temporary is [B, R′, k]."""
        ent, centers, rel_c = params["entity"], params["centers"][rels], params["relation_c"][rels]
        offsets = (ent[t] - ent[h])[:, None, :]
        d = torch.stack([torch.sum(torch.square(offsets - centers[None, :, c]), dim=-1)
                         for c in range(centers.shape[1])], dim=-1)
        rv = rel_c[torch.arange(rel_c.shape[0], device=h.device)[None, :], torch.argmin(d, dim=-1)]
        return distances.residual_energy(self._project_all(params, t, rels) - self._project_all(params, h, rels) - rv,
                                         distance)

    def batch_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """Chunk-sequential fast update, as ``kb2e_tpu.models.ctransr.CTransR.batch_update``.

        The batch is padded to whole chunks of ``min(chunk_size, B)`` (pad
        slots index row 0 and are invalid) and the chunks are applied in
        order; within a chunk every read sees the chunk-start tables and
        duplicate rows' deltas add up:
        * each sample takes the cluster c of its positive offset; both of its
          triples score against ``relation_c[r, c]``;
        * the closed-form gradients of the violating samples go into W and
          the entity rows as in TransR, and into ``relation_c[r, c]`` with
          the α regulariser 2α(r_{r,c} − r), whose opposite goes into
          ``relation[r]`` (r read at the chunk start);
        * sphere norms of the touched entity rows, cluster vectors and rows
          of W, a ball norm of the touched relation rows;
        * one masked iteration of the coupled ‖e·W‖ ≤ 1 descent on the three
          entity groups (h, r), (t, r), (corrupted, r) — no relation group,
          unlike TransR.
        Returns (params, loss summed over the chunks).
        """
        lr = cfg.learning_rate
        dist = self.effective_distance(Distance.from_any(cfg.distance))
        keys = ("ph", "pt", "r", "nh", "nt", "valid")
        chunk = min(self.chunk_size, batch["ph"].shape[0])
        chunks = base.pad_to_chunks({key: batch[key] for key in keys}, chunk)
        ent, rel, rel_c, proj, centers = (params[key] for key in ("entity", "relation", "relation_c", "proj",
                                                                     "centers"))
        n_rel, n_clusters, k = rel_c.shape

        losses = []
        for phi, pti, ri, nhi, nti, vi in zip(*(chunks[key] for key in keys)):
            he, te, ne_h, ne_t = ent[phi], ent[pti], ent[nhi], ent[nti]
            # relation_c[r, c] as row r·C + c of the flat [R·C, k] view.
            flat = ri * n_clusters + _nearest(te - he, centers[ri])
            w = proj[ri]
            rv = rel_c.reshape(-1, k)[flat]
            res_pos = transr._project(te, w) - transr._project(he, w) - rv
            res_neg = transr._project(ne_t, w) - transr._project(ne_h, w) - rv
            e_pos = distances.residual_energy(res_pos, dist)
            e_neg = distances.residual_energy(res_neg, dist)
            viol = (e_pos + cfg.margin > e_neg) & vi
            losses.append(torch.sum(torch.where(viol, cfg.margin + e_pos - e_neg, 0.0)))
            m = viol.to(res_pos.dtype)[:, None]

            def xs(res):
                x = 2.0 * res
                if dist == Distance.L1:
                    x = torch.where(x > 0, 1.0, -1.0)
                return x * m

            x_pos, x_neg = xs(res_pos), xs(res_neg)
            wx_pos = torch.einsum("bji,bi->bj", w, x_pos)
            wx_neg = torch.einsum("bji,bi->bj", w, x_neg)
            idx = torch.cat([phi, pti, nhi, nti])
            d_w = lr * (torch.einsum("bj,bi->bji", he - te, x_pos) - torch.einsum("bj,bi->bji", ne_h - ne_t, x_neg))
            proj = scatter.scatter_add(proj, ri, d_w, cfg.scatter_mode)
            delta = torch.cat([lr * wx_pos, -lr * wx_pos, -lr * wx_neg, lr * wx_neg])
            ent = scatter.scatter_add(ent, idx, delta, cfg.scatter_mode)
            reg = 2.0 * self.alpha * (rv - rel[ri]) * m
            rel_c = scatter.scatter_add(rel_c.reshape(-1, k), flat, lr * (x_pos - x_neg) - lr * reg)
            rel = scatter.scatter_add(rel, ri, lr * reg)

            # Norms of the touched rows (the tables above are new, not the
            # caller's); under a data-parallel step, every rank's rows.
            e_rows, r_rows, c_rows = scatter.touched(idx), scatter.touched(ri), scatter.touched(flat)
            ent[e_rows] = projections.sphere_norm(ent[e_rows])
            rel[r_rows] = projections.ball_norm(rel[r_rows])
            rel_c[c_rows] = projections.sphere_norm(rel_c[c_rows])
            rel_c = rel_c.reshape(n_rel, n_clusters, k)
            proj[r_rows] = projections.sphere_norm(proj[r_rows])

            # One masked iteration of ‖e·W‖ ≤ 1 on the three entity groups:
            # tmp = 2·eW;  W −= lr·outer(e, tmp);  e −= lr·W'·tmp.
            corrupted = torch.where(nhi != phi, nhi, nti)
            pair_e = torch.cat([phi, pti, corrupted])
            e3 = ent[pair_e].reshape(3, chunk, k)
            w_upd = proj[ri]
            p3 = torch.einsum("sbj,bji->sbi", e3, w_upd)
            act = (torch.sum(torch.square(p3), dim=-1, keepdim=True) > 1.0) & viol.repeat(3).reshape(3, chunk, 1)
            tmp3 = torch.where(act, 2.0 * p3, 0.0)
            d_w = -lr * torch.einsum("sbj,sbi->bji", e3, tmp3)
            proj = scatter.scatter_add(proj, ri, d_w, cfg.scatter_mode)
            e_new = e3 - lr * torch.einsum("bji,sbi->sbj", w_upd + d_w, tmp3)
            ent = scatter.scatter_add(ent, pair_e, (e_new - e3).reshape(3 * chunk, k), cfg.scatter_mode)
        out = {"entity": ent, "relation": rel, "relation_c": rel_c, "proj": proj, "centers": centers}
        return out, torch.stack(losses).sum()

    def sequential_update(self, params, batch: base.Batch, cfg: EmbeddingConfig) -> Tuple[base.Params, torch.Tensor]:
        """Parity mode is the fast update (no reference binary exists): never
        TransR's sequential-update kernel, which scores ``relation[r]``."""
        return self.batch_update(params, batch, cfg)

    # Cluster-routed eval hooks.
    def cluster_vectors(self, params, rel: int) -> torch.Tensor:
        """[C, k] cluster vectors of one relation."""
        return params["relation_c"][rel]

    def cluster_centers(self, params, rel: int) -> torch.Tensor:
        """[C, k] offset-space centers of one relation."""
        return params["centers"][rel]


MODEL = base.register(CTransR())
