"""Raw and filtered link-prediction ranks in plain PyTorch, in blocks.

For each test triple (h, r, t) two queries, in this order: replace the head
(score every entity e as dist(e − (t − r)) in relation r's space) and
replace the tail (dist(e − (h + r))).  An entity ranks before the true one
when its energy is lower, or equal with a lower id (``common/evaluation.cpp``
sorts by energy; ties fall to the id); the raw rank is 1 + their number, the
filtered rank leaves out those that complete a triple known in train, valid
or test.  Energies of a block of queries against every entity come from
``torch.cdist`` (L1) or the squared differences summed (L2), in float32 with
TF32 off unless the caller turned it on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import facts

BLOCK = 1024  # queries scored together: a [BLOCK, N] energy matrix


def queries(test) -> Dict[str, np.ndarray]:
    """The 2·|test| queries: anchor, relation, sign of r, true answer and side."""
    h, t, r = (np.asarray(a, np.int64) for a in test)
    n = 2 * h.shape[0]
    out = {"anchor": np.empty(n, np.int64), "rel": np.repeat(r, 2), "sign": np.empty(n, np.float32),
           "true": np.empty(n, np.int64), "head": np.zeros(n, bool)}
    out["anchor"][0::2], out["anchor"][1::2] = t, h
    out["sign"][0::2], out["sign"][1::2] = -1.0, 1.0
    out["true"][0::2], out["true"][1::2] = h, t
    out["head"][0::2] = True
    return out


def _energies(space: torch.Tensor, q: torch.Tensor, l1: bool) -> torch.Tensor:
    if l1:
        return torch.cdist(q[None], space[None], p=1.0)[0]
    out = torch.empty((q.shape[0], space.shape[0]), device=q.device)
    for s in range(0, q.shape[0], 64):  # [64, N, k] differences at a time
        d = space[None] - q[s:s + 64, None]
        out[s:s + 64] = (d * d).sum(-1)
    return out


def ranks(model, tables: Dict, graph: Dict, n_entities: int, n_relations: int, l1: bool,
          device) -> Tuple[np.ndarray, np.ndarray]:
    """(raw, filtered) int64 ranks of every query, in :func:`queries`' order.

    ``model`` is the model's reference module: its ``project`` gives a
    relation's scoring space and ``GROUPED`` says whether that space depends
    on the relation (then each relation's queries are scored together)."""
    q = queries(graph["test"])
    every = [np.concatenate([graph[s][i] for s in ("train", "valid", "test")]) for i in range(3)]
    known = facts.Known(every[0], every[1], every[2], n_entities, n_relations)
    n = q["anchor"].shape[0]
    raw, filt = np.zeros(n, np.int64), np.zeros(n, np.int64)
    if model.GROUPED:
        order = np.argsort(q["rel"], kind="stable")
        cuts = np.flatnonzero(np.diff(q["rel"][order])) + 1
        groups = np.split(order, cuts)
    else:
        groups = [np.arange(n)]
    rel_table = tables["relation"]
    ids = torch.arange(n_entities, device=device)
    for group in groups:
        space = model.project(tables, int(q["rel"][group[0]])) if model.GROUPED else model.project(tables, 0)
        for s in range(0, group.shape[0], BLOCK):
            sel = group[s:s + BLOCK]
            put = lambda a: torch.as_tensor(a[sel], device=device)  # noqa: E731
            anchor, rel, true = put(q["anchor"]), put(q["rel"]), put(q["true"])
            point = space[anchor] + put(q["sign"])[:, None] * rel_table[rel]
            e = _energies(space, point, l1)
            e_true = e.gather(1, true[:, None])
            beats = (e < e_true) | ((e == e_true) & (ids[None] < true[:, None]))
            beats[torch.arange(sel.shape[0], device=device), true] = False
            good = torch.zeros_like(beats)
            for side in ("head", "tail"):
                mask = q["head"][sel] == (side == "head")
                rows, answers = known.pairs(side, q["anchor"][sel][mask], q["rel"][sel][mask])
                good[torch.as_tensor(np.flatnonzero(mask)[rows], device=device),
                     torch.as_tensor(answers, device=device)] = True
            r_raw = 1 + beats.sum(1)
            raw[sel] = r_raw.cpu().numpy()
            filt[sel] = (r_raw - (beats & good).sum(1)).cpu().numpy()
    return raw, filt
