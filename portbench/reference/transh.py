"""TransH in plain PyTorch: tables, energy, the fast update, and its work.

E(h, r, t) = ‖(t − (w_r·t) w_r) − (h − (w_r·h) w_r) − d_r‖₁: head and tail
projected onto relation r's hyperplane, of unit normal w_r, and the
translation d_r on it (Wang et al., AAAI 2014; the reference tool's
``transh/transh.cpp:15-28``, which scores in L1 whatever ``--distance``
says, so ``l1`` is not read here).  Tables: ``entity`` [N, k],
``relation`` [R, k] (d_r) and ``norm`` [R, k] (w_r).

A violating sample's steps (``transh/trainer.cpp:11-46``): x = +1 where
2·res > 0 and −1 elsewhere, per coordinate of the projected residual;
with β = −1 for the positive triple and +1 for the corrupted one,
d_r += −β·lr·x, h += −β·lr·x, t += β·lr·x, and
w_r += β·lr·(x·(w_r·h − w_r·t) + (Σᵢ xᵢ w_rᵢ)·(h − t)).

The fast update applies a batch at once, as the port's fast mode does:

1. every read (energies, directions, w_r·h, w_r·t) comes from the tables
   at the batch's start, and the violating samples' steps add up;
2. the whole entity and relation tables are ball-normed and the whole
   normal table sphere-normed;
3. the projector (below) runs over every relation row and its normal;
4. it runs again over each sample's three (entity, w_r) pairs: head, tail
   and the corrupted entity, invalid samples included; each pair's change
   is added back to its row and the three changes of w_r summed into its
   normal, so a row named twice takes both; then the normal table is
   sphere-normed again.

Departures from the paper, each the reference tool's or the port's:

* the paper keeps |w_r·e| ≤ ‖e‖ and w_r ⊥ d_r soft, through a loss term
  weighted by C; the reference tool instead projects after each step with
  its coupled loop (``common/utils.cpp:79-111``, :func:`orthogonalize`);
* the reference tool's loop runs until the pair is satisfied; here, as in
  the port, it stops after ``CAP`` = 16 trips;
* the reference tool steps one sample at a time, each reading what the one
  before wrote; the fast update reads the batch's start (1. above) and
  projects every touched pair from the state after all the steps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import kge
from portbench.roofline import Work

LEAVES = ("entity", "relation", "norm")
GROUPED = True  # eval ranks each relation's queries on that relation's hyperplane
CAP = 16  # the projector's trips (the configuration's projection_max_iters)
TIGHT = 0.1  # the projector stops a pair once b̂·a is at most this


def init_tables(generator: torch.Generator, n_entities: int, n_relations: int, k: int, kind: str) -> Dict:
    """TransH's init, randn(0, 1/k, ±1) for every table
    (``transh/trainer.cpp:61-63, 77-88``): entity and relation rows
    ball-normed, the normals sphere-normed; the same for train and eval."""
    def draw(n):
        return kge.truncated_normal(generator, (n, k), 1.0 / k, 1.0)

    return {"entity": kge.ball_norm(draw(n_entities)), "relation": kge.ball_norm(draw(n_relations)),
            "norm": kge.sphere_norm(draw(n_relations))}


def project(tables: Dict, rel: int) -> torch.Tensor:
    """The entity table on relation ``rel``'s hyperplane."""
    ent, w = tables["entity"], tables["norm"][rel]
    return ent - (ent @ w)[:, None] * w


def orthogonalize(a: torch.Tensor, b: torch.Tensor, rate: float, trips: int = CAP):
    """The reference tool's ``norm(a, b, rate)`` on rows [M, k], ``trips``
    masked trips with no early exit.

    b starts sphere-normed and s at 0.  A trip sets s ← √(s + Σb²) (s is
    never reset) and b̂ = b/s; where b̂·a > ``TIGHT`` it sets a ← a − rate·b̂
    and b ← b̂ − rate·a (the new a) and the row goes on; elsewhere b ← b̂ and
    the row stops.  A stopped row is never written again, so running every
    trip gives what stopping when no row goes on gives.  b ends sphere-normed.
    """
    b = kge.sphere_norm(b)
    s = torch.zeros_like(b[:, :1])
    going = torch.ones_like(s, dtype=torch.bool)
    for _ in range(trips):
        s_trip = torch.sqrt(s + (b * b).sum(-1, keepdim=True))
        unit = b / s_trip
        fires = going & ((unit * a).sum(-1, keepdim=True) > TIGHT)
        a = torch.where(fires, a - rate * unit, a)
        b = torch.where(fires, unit - rate * a, torch.where(going, unit, b))
        s = torch.where(going, s_trip, s)
        going = fires
    return a, kge.sphere_norm(b)


def _on_plane(e, w):
    """e − (w·e) w, and w·e."""
    dot = (w * e).sum(-1, keepdim=True)
    return e - dot * w, dot


def _batch(ent, rel, nrm, b, lr: float, margin: float):
    h, t, r, nh, nt = (b[key].long() for key in ("ph", "pt", "r", "nh", "nt"))
    d, w = rel[r], nrm[r]
    parts = []
    for head, tail in ((h, t), (nh, nt)):
        eh, et = ent[head], ent[tail]
        ph_, wh = _on_plane(eh, w)
        pt_, wt = _on_plane(et, w)
        res = pt_ - ph_ - d
        parts.append((eh, et, wh, wt, res, res.abs().sum(-1)))
    (eh, et, wh, wt, res_pos, e_pos), (enh, ent_, wnh, wnt, res_neg, e_neg) = parts
    viol = (e_pos + margin > e_neg) & b["valid"]
    loss = torch.where(viol, margin + e_pos - e_neg, 0.0).sum()
    m = viol.float()[:, None]
    x_pos, x_neg = kge.direction(res_pos, True) * m, kge.direction(res_neg, True) * m
    step_pos, step_neg = lr * x_pos, lr * x_neg
    turn_pos = x_pos * (wh - wt) + (x_pos * w).sum(-1, keepdim=True) * (eh - et)
    turn_neg = x_neg * (wnh - wnt) + (x_neg * w).sum(-1, keepdim=True) * (enh - ent_)

    rel = rel.index_add(0, r, step_pos - step_neg)
    nrm = nrm.index_add(0, r, lr * turn_neg - lr * turn_pos)
    ent = ent.index_add(0, torch.cat([h, t, nh, nt]), torch.cat([step_pos, -step_pos, -step_neg, step_neg]))
    ent, rel, nrm = kge.ball_norm(ent), kge.ball_norm(rel), kge.sphere_norm(nrm)

    rel, nrm = orthogonalize(rel, nrm, lr)
    pairs = torch.cat([h, t, torch.where(nh != h, nh, nt)])
    e_rows, w_rows = ent[pairs], nrm[r].repeat(3, 1)
    e_new, w_new = orthogonalize(e_rows, w_rows, lr)
    ent = ent.index_add(0, pairs, e_new - e_rows)
    nrm = kge.sphere_norm(nrm.index_add(0, r, (w_new - w_rows).view(3, -1, w_rows.shape[-1]).sum(0)))
    return ent, rel, nrm, loss


def fast_epoch(tables: Dict, batches: Dict, lr: float, margin: float, l1: bool) -> Tuple[Dict, float]:
    """The epoch's batches ([n, rows] tensors, as the sampler drew them) in
    order; returns the tables and the epoch's loss."""
    ent, rel, nrm = (tables[key].float() for key in LEAVES)
    loss = torch.zeros((), device=ent.device)
    for i in range(batches["ph"].shape[0]):
        ent, rel, nrm, batch_loss = _batch(ent, rel, nrm, {key: v[i] for key, v in batches.items()}, lr, margin)
        loss += batch_loss
    return {"entity": ent, "relation": rel, "norm": nrm}, float(loss)


def update_work(k: int, batches: Dict) -> List[Work]:
    """(operations, bytes) of each batch of an epoch: a lower bound.

    The least a batch needs, whatever the program does beyond it (the port
    norms and projects whole tables and may run the projector up to ``CAP``
    trips).  Bytes: each distinct entity row, relation row and normal the
    batch touches read once and written once, and the batch's five ids and
    valid flag read.  Operations, in instructions per coordinate (each
    counted as two operations): per sample 36, that is 10 for each triple
    (w·h, w·t, the two projections, two subtractions, the energy, the
    direction, Σx·w and the step), 9 for the normal's step and 7 for the
    adds into the sample's six rows; per distinct row 2 for its norm; and
    one projector trip, 3 (Σb², b·a and the scale), over each sample's three
    pairs and each touched relation.
    """
    out = []
    for i in range(batches["ph"].shape[0]):
        rows = batches["ph"][i].shape[0]
        ents = kge.distinct(*(batches[key][i] for key in ("ph", "pt", "nh", "nt")))
        rels = kge.distinct(batches["r"][i])
        ops = 2 * k * (36 * rows + 2 * (ents + 2 * rels) + 3 * (3 * rows + rels))
        nbytes = 2 * 4 * k * (ents + 2 * rels) + (5 * 4 + 1) * rows
        out.append((float(ops), float(nbytes)))
    return out


def projection_work(k: int, n_entities: int, group_queries) -> Work:
    """Eval projects every entity once per relation group: w·e and e − (w·e)w,
    two instructions per entity and coordinate.  Its bytes are the group's
    table, which the ranking sweep's count already reads."""
    return float(2 * 2 * n_entities * k * len(group_queries)), 0.0
