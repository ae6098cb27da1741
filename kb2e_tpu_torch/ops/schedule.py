"""The order in which the sequential-update kernels may run samples side by side.

A sample of the TransE, TransH or TransR parity update
(``ops/transe_update.py``, ``ops/transh_update.py``,
``ops/transr_update.py``) reads and writes only its own rows of the output
tables: its entities h, t, h', t' and its relation's rows (r, and w_r or
W_r).  Two updates that share no row commute exactly, so any order that
keeps, for every row, the updates that touch it in batch order gives the
sequential result bit for bit.  :func:`row_predecessors` lists, for each
update, the latest earlier update of each of its rows; the kernels' update
pass (``csrc/ordered.cuh``) runs a sample once those have finished.

This is index bookkeeping, in plain torch on the batch's device, with no
host sync.
"""

from __future__ import annotations

import numpy as np
import torch


def update_rows(ph: torch.Tensor, pt: torch.Tensor, nh: torch.Tensor, nt: torch.Tensor, r: torch.Tensor,
                n_entities: int) -> torch.Tensor:
    """int64 [B, 5]: the row keys each sample touches; entity ids as they
    are, the relation (its row, and its w_r or W_r) as ``n_entities + r``."""
    return torch.stack([ph, pt, nh, nt, r.to(torch.int64) + n_entities], 1).to(torch.int64)


def check_ids(what: str, ph: torch.Tensor, pt: torch.Tensor, r: torch.Tensor, nh: torch.Tensor, nt: torch.Tensor,
              n_entities: int, n_relations: int) -> None:
    """Raises ValueError unless every entity id lies in [0, n_entities) and
    every relation id in [0, n_relations): a kernel would read and write
    outside its tables.  One host sync."""
    if not ph.shape[0]:
        return
    ids = torch.stack([ph, pt, nh, nt])
    lo, hi, rlo, rhi = torch.stack([ids.min(), ids.max(), r.min(), r.max()]).tolist()
    if lo < 0 or hi >= n_entities or rlo < 0 or rhi >= n_relations:
        raise ValueError(
            f"{what}: entity ids in [{lo}, {hi}] or relation ids in [{rlo}, {rhi}] "
            f"fall outside [0, {n_entities}) / [0, {n_relations})"
        )


def row_predecessors(rows: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """int32 [B, m]: ``pred[i, j]`` is the latest earlier active sample that
    lists ``rows[i, j]``, or −1 where there is none, where sample i lists
    that row a second time (h == t, h == h′, ...), and for every inactive
    sample.

    ``rows`` is int [B, m] of non-negative row keys, ``active`` bool [B].
    Keys ``row·B + i`` of the listed entries are sorted; each entry's
    neighbour below it in the sort is the previous toucher of its row.
    """
    b, m = rows.shape
    rows = rows.to(torch.int64)
    dev = rows.device
    # A row a sample lists again counts once: masked, or the sample would
    # wait on itself.
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    repeat = ((rows[:, :, None] == rows[:, None, :]) & earlier).any(2)
    listed = active.to(torch.bool)[:, None] & ~repeat
    sample = torch.arange(b, device=dev)[:, None]
    unlisted = torch.iinfo(torch.int64).max  # sorts after every listed key
    keys, perm = torch.sort(torch.where(listed, rows * b + sample, unlisted).reshape(-1))
    below, here = keys[:-1], keys[1:]
    same_row = (here != unlisted) & (here // max(b, 1) == below // max(b, 1))
    pred_sorted = torch.full_like(keys, -1)
    pred_sorted[1:] = torch.where(same_row, below % max(b, 1), -1)
    pred = torch.empty_like(pred_sorted)
    pred[perm] = pred_sorted
    return pred.reshape(b, m).to(torch.int32)


def chain_levels(pred: torch.Tensor, active: torch.Tensor) -> np.ndarray:
    """int64 [B] on the host: each active sample's place in its longest
    chain of predecessors, from 1; 0 for inactive samples.  The largest is
    the least number of steps in which the update pass can run the batch."""
    pred, active = pred.cpu().numpy(), active.cpu().numpy().astype(bool)
    level = np.zeros(pred.shape[0], dtype=np.int64)
    for i in np.flatnonzero(active):
        before = pred[i][pred[i] >= 0]
        level[i] = 1 + (level[before].max() if before.size else 0)
    return level
