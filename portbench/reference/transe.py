"""TransE in plain PyTorch: tables, energy, the fast update, and its work.

E(h, r, t) = dist(t − h − r) (``transe/transe.cpp:10-28``).  The fast update
applies a batch at once (the double-buffered batch of
``transe/trainer.cpp:48-56``): every read comes from the batch's start, the
violating samples' steps add up (h += lr·x, t −= lr·x on the positive, the
opposite on the corrupted triple, r += lr·(x_pos − x_neg)), and the touched
rows are then ball-normed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import kge
from portbench.roofline import Work

LEAVES = ("entity", "relation")
GROUPED = False  # eval ranks every query in one space, not per relation


def init_tables(generator: torch.Generator, n_entities: int, n_relations: int, k: int, kind: str) -> Dict:
    """The tables a run starts from: TransE's init, randn(0, 1/k, ±6/√k)
    (``transe/trainer.cpp:21-23``), every row ball-normed."""
    bound = 6.0 / k ** 0.5
    return {"entity": kge.ball_norm(kge.truncated_normal(generator, (n_entities, k), 1.0 / k, bound)),
            "relation": kge.ball_norm(kge.truncated_normal(generator, (n_relations, k), 1.0 / k, bound))}


def project(tables: Dict, rel: int) -> torch.Tensor:
    """The entity table in relation ``rel``'s scoring space."""
    return tables["entity"]


def _batch(ent, rel, b, lr: float, margin: float, l1: bool):
    h, t, r, nh, nt = (b[key].long() for key in ("ph", "pt", "r", "nh", "nt"))
    res_pos = ent[t] - ent[h] - rel[r]
    res_neg = ent[nt] - ent[nh] - rel[r]
    e_pos, e_neg = kge.energy(res_pos, l1), kge.energy(res_neg, l1)
    viol = (e_pos + margin > e_neg) & b["valid"]
    loss = torch.where(viol, margin + e_pos - e_neg, 0.0).sum()
    m = viol.float()[:, None]
    x_pos, x_neg = kge.direction(res_pos, l1) * m, kge.direction(res_neg, l1) * m
    rows = torch.cat([h, t, nh, nt])
    ent = ent.index_add(0, rows, lr * torch.cat([x_pos, -x_pos, -x_neg, x_neg]))
    rel = rel.index_add(0, r, lr * (x_pos - x_neg))
    ent = torch.where(kge.touched(ent.shape[0], rows), kge.ball_norm(ent), ent)
    rel = torch.where(kge.touched(rel.shape[0], r), kge.ball_norm(rel), rel)
    return ent, rel, loss


def fast_epoch(tables: Dict, batches: Dict, lr: float, margin: float, l1: bool) -> Tuple[Dict, float]:
    """The epoch's batches ([n, rows] tensors, as the sampler drew them) in
    order; returns the tables and the epoch's loss."""
    ent, rel = tables["entity"].float(), tables["relation"].float()
    loss = torch.zeros((), device=ent.device)
    for i in range(batches["ph"].shape[0]):
        ent, rel, batch_loss = _batch(ent, rel, {key: v[i] for key, v in batches.items()}, lr, margin, l1)
        loss += batch_loss
    return {"entity": ent, "relation": rel}, float(loss)


def update_work(k: int, batches: Dict) -> List[Work]:
    """(operations, bytes) of each batch of an epoch.

    Bytes: each distinct row the batch touches (entity and relation) read
    once and written once, and the batch's five ids and valid flag read.
    Operations per row and coordinate: 4 subtractions for the two residuals,
    2 absolute-adds for the energies, 2 for the directions, 6 for the
    steps (five scales and x_pos − x_neg) and 5 adds into the rows; per
    distinct row and coordinate 2 for its norm (a square-add and a scale).
    Each instruction counts as two operations.
    """
    out = []
    for i in range(batches["ph"].shape[0]):
        rows = batches["ph"][i].shape[0]
        touched = kge.distinct(*(batches[key][i] for key in ("ph", "pt", "nh", "nt"))) + kge.distinct(batches["r"][i])
        ops = 2 * (19 * rows * k + 2 * touched * k)
        nbytes = 2 * 4 * k * touched + (5 * 4 + 1) * rows
        out.append((float(ops), float(nbytes)))
    return out


def projection_work(k: int, n_entities: int, group_queries) -> Work:
    """TransE scores in the entity space itself: no projection."""
    return 0.0, 0.0
