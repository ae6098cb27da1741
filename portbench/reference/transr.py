"""TransR in plain PyTorch: tables, energy, the fast update, and its work.

E(h, r, t) = dist(t·W_r − h·W_r − r) (``transr/transr.cpp:13-37``; W_r is
[k, k] laid out [input j, output i], so a row projects as e @ W_r).  The
fast update is chunk-sequential (Lin et al., AAAI 2015, with the reference's
steps of ``transr/trainer.cpp:144-191``): each chunk reads its start, adds
the violating samples' steps

  W_r += lr·(outer(h − t, x_pos) − outer(h′ − t′, x_neg)),
  h += lr·W x_pos, t −= lr·W x_pos, h′ −= lr·W x_neg, t′ += lr·W x_neg,
  r += lr·(x_pos − x_neg),

sphere-norms every row the chunk touches (entities, relations and each row
of a touched W_r, invalid slots included), then takes one step of the
‖a·W_r‖ ≤ 1 descent (``transRNorm``) on the pairs (h, W_r), (t, W_r),
(the corrupted entity, W_r) and (r, W_r) of the violating samples:
tmp = 2·a·W_r where ‖a·W_r‖² > 1, W_r −= lr·outer(a, tmp), a −= lr·(W_r + ΔW)·tmp.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import kge
from portbench.roofline import Work

LEAVES = ("entity", "relation", "proj")
GROUPED = True  # eval ranks each relation's queries in that relation's space


def init_tables(generator: torch.Generator, n_entities: int, n_relations: int, k: int, kind: str) -> Dict:
    """TransR's init, randn(0, 1/k, ±1) ball-normed (``transr/trainer.cpp:67-86``),
    W = I for training; for eval W = I plus seeded noise of the same scale,
    so that the projection changes the ranks."""
    ent = kge.ball_norm(kge.truncated_normal(generator, (n_entities, k), 1.0 / k, 1.0))
    rel = kge.ball_norm(kge.truncated_normal(generator, (n_relations, k), 1.0 / k, 1.0))
    proj = torch.eye(k, device=generator.device).expand(n_relations, k, k).clone()
    if kind == "eval":
        proj += kge.truncated_normal(generator, (n_relations, k, k), 1.0 / k, 1.0)
    return {"entity": ent, "relation": rel, "proj": proj}


def project(tables: Dict, rel: int) -> torch.Tensor:
    return tables["entity"] @ tables["proj"][rel]


def _chunk(ent, rel, proj, b, lr: float, margin: float, l1: bool):
    h, t, r, nh, nt = (b[key].long() for key in ("ph", "pt", "r", "nh", "nt"))
    w = proj[r]

    def through(rows):  # rows · W_r, one sample a row
        return torch.bmm(rows[:, None, :], w)[:, 0]

    eh, et, enh, ent_ = ent[h], ent[t], ent[nh], ent[nt]
    res_pos = through(et) - through(eh) - rel[r]
    res_neg = through(ent_) - through(enh) - rel[r]
    e_pos, e_neg = kge.energy(res_pos, l1), kge.energy(res_neg, l1)
    viol = (e_pos + margin > e_neg) & b["valid"]
    loss = torch.where(viol, margin + e_pos - e_neg, 0.0).sum()
    m = viol.float()[:, None]
    x_pos, x_neg = kge.direction(res_pos, l1) * m, kge.direction(res_neg, l1) * m
    wx_pos, wx_neg = torch.bmm(w, x_pos[:, :, None])[..., 0], torch.bmm(w, x_neg[:, :, None])[..., 0]
    d_w = (eh - et)[:, :, None] * x_pos[:, None, :] - (enh - ent_)[:, :, None] * x_neg[:, None, :]
    proj = proj.index_add(0, r, lr * d_w)
    rel = rel.index_add(0, r, lr * (x_pos - x_neg))
    ent = ent.index_add(0, torch.cat([h, t, nh, nt]), lr * torch.cat([wx_pos, -wx_pos, -wx_neg, wx_neg]))

    rows, rels = kge.touched(ent.shape[0], h, t, nh, nt), kge.touched(rel.shape[0], r)
    ent = torch.where(rows, kge.sphere_norm(ent), ent)
    rel = torch.where(rels, kge.sphere_norm(rel), rel)
    proj = torch.where(rels[:, :, None], kge.sphere_norm(proj), proj)

    # One step of transRNorm on the four pairs of each violating sample.
    corrupted = torch.where(nh != h, nh, nt)
    w = proj[r]
    a = torch.stack([ent[h], ent[t], ent[corrupted], rel[r]])  # [4, c, k]
    p = torch.einsum("scj,cji->sci", a, w)
    act = ((p * p).sum(-1, keepdim=True) > 1.0) & viol[None, :, None]
    tmp = torch.where(act, 2.0 * p, 0.0)
    d_w = -lr * torch.einsum("scj,sci->cji", a, tmp)
    proj = proj.index_add(0, r, d_w)
    step = -lr * torch.einsum("cji,sci->scj", w + d_w, tmp)
    ent = ent.index_add(0, torch.cat([h, t, corrupted]), step[:3].reshape(-1, step.shape[-1]))
    rel = rel.index_add(0, r, step[3])
    return ent, rel, proj, loss


def fast_epoch(tables: Dict, batches: Dict, lr: float, margin: float, l1: bool) -> Tuple[Dict, float]:
    """The epoch's chunks ([n_chunks, chunk] tensors, as the sampler drew and
    padded them) in order; returns the tables and the epoch's loss."""
    ent, rel, proj = (tables[key].float() for key in LEAVES)
    loss = torch.zeros((), device=ent.device)
    for i in range(batches["ph"].shape[0]):
        ent, rel, proj, chunk_loss = _chunk(ent, rel, proj, {key: v[i] for key, v in batches.items()},
                                            lr, margin, l1)
        loss += chunk_loss
    return {"entity": ent, "relation": rel, "proj": proj}, float(loss)


def update_work(k: int, batches: Dict) -> List[Work]:
    """(operations, bytes) of each chunk of an epoch.

    Bytes: each distinct entity row, relation row and matrix W_r the chunk
    touches read once and written once, and its five ids and valid flag read.
    Operations, in instructions per sample (each counted as two operations):
    23·k² for the products with W_r (four projections and two W·x in the
    step, the outer products of ΔW and their adds, four projections, ΔW,
    W + ΔW and the four steps of the descent), 20·k for the residuals,
    energies, directions, row steps and adds, and per distinct row 2·k for
    its sphere norm (2·k² for a matrix's).
    """
    out = []
    for i in range(batches["ph"].shape[0]):
        c = batches["ph"][i].shape[0]
        rows = kge.distinct(*(batches[key][i] for key in ("ph", "pt", "nh", "nt")))
        rels = kge.distinct(batches["r"][i])
        ops = 2 * (23 * c * k * k + 20 * c * k + 2 * k * (rows + rels) + 2 * rels * k * k)
        nbytes = 2 * 4 * (rows * k + rels * k + rels * k * k) + (5 * 4 + 1) * c
        out.append((float(ops), float(nbytes)))
    return out


def projection_work(k: int, n_entities: int, group_queries) -> Work:
    """Eval projects every entity once per relation group: N·k² fused
    multiply-adds a group.  Its bytes are the group's table, which the
    ranking sweep's count already reads."""
    return float(2 * n_entities * k * k * len(group_queries)), 0.0
