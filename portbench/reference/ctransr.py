"""CTransR in plain PyTorch: tables, the fast update, and its work.

Lin et al., AAAI 2015, §"CTransR": the triples of each relation are
clustered by their offsets t − h; each cluster c of relation r has its own
vector r_{r,c}, all of a relation's clusters share its matrix W_r, and the
regulariser α‖r_{r,c} − r‖² keeps the cluster vectors near r.
E(h, r, t) = dist(t·W_r − h·W_r − r_{r,c}) (W_r laid out [input j, output i],
as in ``reference/transr.py``).

The fast update is TransR's chunk-sequential one (``reference/transr.py``)
with these changes: each sample takes, at the start of its chunk, the cluster
c whose center is nearest its positive offset e_t − e_h by ‖o − ce_c‖² (the
first such c), and both of its triples score against r_{r,c}; a violating
sample's step goes into r_{r,c} with the regulariser's step:

  r_{r,c} += lr·(x_pos − x_neg) − lr·2α(r_{r,c} − r),  r += lr·2α(r_{r,c} − r),

r and r_{r,c} read at the chunk's start.  Then the sphere norms of every
touched entity row, cluster row and row of a touched W_r, a ball norm of the
touched relation rows, and one step of the ‖e·W_r‖ ≤ 1 descent on the pairs
(h, W_r), (t, W_r) and (the corrupted entity, W_r) of the violating samples.

Departures from the paper, each a documented choice of the port
(``kb2e_tpu_torch/models/ctransr.py``, whose JAX counterpart defines it):

* the paper assigns each triple its cluster once, from the k-means of its
  TransE offset; here a triple is routed at the start of each chunk, by the
  current entity rows, to the nearest of fixed centers;
* the corrupted triple scores against its positive triple's cluster;
* the regulariser's step is taken only for the samples that violate the
  margin, as the margin loss's step is;
* the relation rows are ball-normed and the cluster rows sphere-normed, and
  the ‖e·W_r‖ ≤ 1 descent leaves the relation vectors out;
* C = 4 clusters and α = 1.0: the port's defaults, since the paper's values
  are not in the repository;
* ``init_tables`` stands in for a TransE warm start and its k-means:
  TransR's seeded init, ``relation_c`` the broadcast of its relation table
  (the port keeps the random init's ``relation_c`` under a warm start), and
  the centers offsets e_a − e_b of seeded random entity pairs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import kge, transr
from portbench.roofline import Work

N_CLUSTERS = 4
ALPHA = 1.0
LEAVES = ("entity", "relation", "relation_c", "proj")  # the trained tables; ``centers`` only routes
GROUPED = True


def init_tables(generator: torch.Generator, n_entities: int, n_relations: int, k: int, kind: str) -> Dict:
    """TransR's init (``reference/transr.py``), ``relation_c`` the relation
    table broadcast over the clusters, and the centers offsets e_a − e_b of
    N_CLUSTERS seeded random entity pairs a relation."""
    tables = transr.init_tables(generator, n_entities, n_relations, k, kind)
    rel_c = tables["relation"][:, None, :].expand(n_relations, N_CLUSTERS, k).clone()
    a, b = (torch.randint(n_entities, (n_relations, N_CLUSTERS), generator=generator, device=generator.device)
            for _ in range(2))
    return {**tables, "relation_c": rel_c, "centers": tables["entity"][a] - tables["entity"][b]}


def project(tables: Dict, rel: int) -> torch.Tensor:
    raise NotImplementedError("CTransR's eval scores each (query, candidate) pair against its own cluster "
                              "vector, which no one projected table expresses")


def _chunk(ent, rel, rel_c, proj, centers, b, lr: float, margin: float, l1: bool):
    h, t, r, nh, nt = (b[key].long() for key in ("ph", "pt", "r", "nh", "nt"))
    n_rel, n_clusters, k = rel_c.shape
    w = proj[r]

    def through(rows):  # rows · W_r, one sample a row
        return torch.bmm(rows[:, None, :], w)[:, 0]

    eh, et, enh, ent_ = ent[h], ent[t], ent[nh], ent[nt]
    cluster = (((et - eh)[:, None, :] - centers[r]) ** 2).sum(-1).argmin(1)
    flat = r * n_clusters + cluster
    rc = rel_c.reshape(-1, k)
    rv = rc[flat]
    res_pos = through(et) - through(eh) - rv
    res_neg = through(ent_) - through(enh) - rv
    e_pos, e_neg = kge.energy(res_pos, l1), kge.energy(res_neg, l1)
    viol = (e_pos + margin > e_neg) & b["valid"]
    loss = torch.where(viol, margin + e_pos - e_neg, 0.0).sum()
    m = viol.float()[:, None]
    x_pos, x_neg = kge.direction(res_pos, l1) * m, kge.direction(res_neg, l1) * m
    wx_pos, wx_neg = torch.bmm(w, x_pos[:, :, None])[..., 0], torch.bmm(w, x_neg[:, :, None])[..., 0]
    d_w = (eh - et)[:, :, None] * x_pos[:, None, :] - (enh - ent_)[:, :, None] * x_neg[:, None, :]
    reg = 2.0 * ALPHA * (rv - rel[r]) * m
    proj = proj.index_add(0, r, lr * d_w)
    rc = rc.index_add(0, flat, lr * (x_pos - x_neg) - lr * reg)
    rel = rel.index_add(0, r, lr * reg)
    ent = ent.index_add(0, torch.cat([h, t, nh, nt]), lr * torch.cat([wx_pos, -wx_pos, -wx_neg, wx_neg]))

    rows, rels = kge.touched(ent.shape[0], h, t, nh, nt), kge.touched(n_rel, r)
    ent = torch.where(rows, kge.sphere_norm(ent), ent)
    rel = torch.where(rels, kge.ball_norm(rel), rel)
    rc = torch.where(kge.touched(rc.shape[0], flat), kge.sphere_norm(rc), rc)
    proj = torch.where(rels[:, :, None], kge.sphere_norm(proj), proj)

    # One step of the ‖e·W_r‖ ≤ 1 descent on the three entity pairs.
    corrupted = torch.where(nh != h, nh, nt)
    w = proj[r]
    a = torch.stack([ent[h], ent[t], ent[corrupted]])  # [3, c, k]
    p = torch.einsum("scj,cji->sci", a, w)
    act = ((p * p).sum(-1, keepdim=True) > 1.0) & viol[None, :, None]
    tmp = torch.where(act, 2.0 * p, 0.0)
    d_w = -lr * torch.einsum("scj,sci->cji", a, tmp)
    proj = proj.index_add(0, r, d_w)
    step = -lr * torch.einsum("cji,sci->scj", w + d_w, tmp)
    ent = ent.index_add(0, torch.cat([h, t, corrupted]), step.reshape(-1, k))
    return ent, rel, rc.reshape(n_rel, n_clusters, k), proj, loss


def fast_epoch(tables: Dict, batches: Dict, lr: float, margin: float, l1: bool) -> Tuple[Dict, float]:
    """The epoch's chunks ([n_chunks, chunk] tensors, as the sampler drew and
    padded them) in order; returns the tables (the centers as given) and the
    epoch's loss."""
    ent, rel, rel_c, proj = (tables[key].float() for key in LEAVES)
    centers = tables["centers"].float()
    loss = torch.zeros((), device=ent.device)
    for i in range(batches["ph"].shape[0]):
        ent, rel, rel_c, proj, chunk_loss = _chunk(ent, rel, rel_c, proj, centers,
                                                   {key: v[i] for key, v in batches.items()}, lr, margin, l1)
        loss += chunk_loss
    return {"entity": ent, "relation": rel, "relation_c": rel_c, "proj": proj, "centers": centers}, float(loss)


def update_work(k: int, batches: Dict) -> List[Work]:
    """(operations, bytes) of each chunk of an epoch.

    TransR's count (``reference/transr.py::update_work``) with three pairs in
    the descent where TransR has four (20·k² a sample for the products with
    W_r where TransR has 23), plus the routing (the offset and its squared
    distance to each of the C centers, (2·C + 1)·k), the cluster row and the
    regulariser (7·k) a sample, and the sphere norm of each cluster row
    touched.  Bytes add the cluster rows, read and written, and the C
    centers of each touched relation, read.  Which cluster a sample takes is
    not known from its ids, so a touched relation counts one cluster row:
    the fewest it can have."""
    out = []
    for i in range(batches["ph"].shape[0]):
        c = batches["ph"][i].shape[0]
        rows = kge.distinct(*(batches[key][i] for key in ("ph", "pt", "nh", "nt")))
        rels = kge.distinct(batches["r"][i])
        ops = 2 * (20 * c * k * k + (20 + 7 + 2 * N_CLUSTERS + 1) * c * k + 2 * k * (rows + 2 * rels)
                   + 2 * rels * k * k)
        nbytes = 2 * 4 * (rows * k + 2 * rels * k + rels * k * k) + 4 * rels * N_CLUSTERS * k + (5 * 4 + 1) * c
        out.append((float(ops), float(nbytes)))
    return out


def projection_work(k: int, n_entities: int, group_queries) -> Work:
    """Eval's projections, as TransR's (no eval cell runs CTransR)."""
    return transr.projection_work(k, n_entities, group_queries)
