"""The comparison that decides ``correct``: the numbers and their limits.

Training.  Two stages are followed by the plain reference, each on the same
batches as the program:

* the start: set-up samples the first epoch with the program's epoch runner
  and applies its first batches (TransR: its chunks), one ``apply`` call
  each, from the benchmark's tables; the reference follows from the same
  tables;
* the window's call: after the window the runner samples one more epoch and
  applies it in one ``apply`` call, the feed shaped as the window's, with
  all but its first batches masked out (invalid), from the tables the
  window left; the reference follows from a copy of those tables.  The
  window's own epochs cannot be followed: a decision that rounding flips (a
  margin or a sign at a tie) moves rows by a whole step of lr, and over an
  epoch such flips avalanche through the shared rows, so two sound runs of
  an epoch differ by 1e-4, as much as a lower precision makes them.

The sampler's draws are judged exactly (``reference/sampler.py``) on the
first epoch, a sample of the window's epochs drawn from the seed, and the
check's epoch.  Numbers:

* ``loss_gap``: the widest gap of a start step's loss, over the reference's.
* ``change1_gap`` and ``change3_gap``: the worst table (leaf) of the gap
  between the norms of the program's change and the reference's change,
  after the first start step and after the last, each over the larger of
  that leaf's reference change and the median leaf's.  A leaf whose
  reference change is under a thousandth of the median leaf's moves by
  rounding alone and is not counted.
* ``window_loss_gap`` and ``window_change_gap``: the same of the window's
  call.
* ``bad_negatives``: rows that are not a train triple and a corruption of it
  that is absent from the train split (exact: limit 0).
* ``bern_z``: the z-score of the tail replacements against bern's odds.
* ``repeated_epochs``: judged epochs whose corrupted entities equal an
  earlier judged epoch's (exact: limit 0).

Eval.  Every pass of the window ranks every test query; after the window
the reference ranks them once (``reference/ranks.py``).  ``rank_mismatch``
is the share of the window's answers whose raw or filtered rank differs
from the reference's (a missing answer counts as differing).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import ranks as ref_ranks
from portbench.reference import sampler


def _norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm())


def change_gap(leaves: Sequence[str], prog_start: Dict, prog: Dict, ref_start: Dict, ref: Dict,
               counted: Sequence[str]) -> float:
    """The worst counted leaf's gap between the norms of the two changes."""
    ref_change = {leaf: _norm(ref[leaf], ref_start[leaf]) for leaf in leaves}
    median = statistics.median(ref_change.values())
    return max(abs(_norm(prog[leaf], prog_start[leaf]) - ref_change[leaf]) / max(ref_change[leaf], median, 1e-30)
               for leaf in counted)


def moving_leaves(leaves: Sequence[str], start: Dict, after_one: Dict) -> List[str]:
    """The leaves whose change after one step is at least a thousandth of the median leaf's."""
    change = {leaf: _norm(after_one[leaf], start[leaf]) for leaf in leaves}
    median = statistics.median(change.values())
    return [leaf for leaf in leaves if change[leaf] >= 1e-3 * median]


def repeated_epochs(epochs: List[Dict]) -> float:
    """Epochs whose corrupted entities equal an earlier epoch's."""
    return float(sum(any(torch.equal(b["nh"], a["nh"]) and torch.equal(b["nt"], a["nt"]) for a in epochs[:i])
                     for i, b in enumerate(epochs)))


def train_numbers(model, prog_start: Dict, ref_start: Dict, prog_states: List[Dict], prog_losses: List[float],
                  epochs: List[Dict], window_call, graph, n_entities: int, n_relations: int, hp: Dict, rows: int,
                  device) -> Dict[str, float]:
    """The training numbers.  The start: ``prog_losses`` of each step and
    ``prog_states`` after the first and the last, on the first batches of
    ``epochs[0]``.  ``epochs``: every judged epoch ([n, rows] tensors as the
    sampler drew them; ``rows`` real rows in all).  ``window_call``: the
    window's call, as (the program's tables before it, its masked feed,
    the tables after it, its loss).  ``model`` is the model's reference
    module, ``hp`` the run's learning_rate, margin, num_negatives and l1."""
    numbers = sampler.judge(epochs, graph["train"], n_entities, n_relations, hp["num_negatives"], rows, device)
    numbers["repeated_epochs"] = repeated_epochs(epochs)
    lr, margin, l1 = hp["learning_rate"], hp["margin"], hp["l1"]
    tables, ref_states, ref_losses = ref_start, [], []
    for i in range(len(prog_losses)):
        tables, loss = model.fast_epoch(tables, {key: v[i:i + 1] for key, v in epochs[0].items()}, lr, margin, l1)
        ref_states.append(tables)
        ref_losses.append(loss)
    counted = moving_leaves(model.LEAVES, ref_start, ref_states[0])
    numbers["loss_gap"] = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    numbers["change1_gap"] = change_gap(model.LEAVES, prog_start, prog_states[0], ref_start, ref_states[0], counted)
    numbers["change3_gap"] = change_gap(model.LEAVES, prog_start, prog_states[-1], ref_start, ref_states[-1],
                                        counted)
    start, feed, prog_end, prog_loss = window_call
    ref_start = {key: v.float() for key, v in start.items()}
    ref_end, ref_loss = model.fast_epoch(ref_start, feed, lr, margin, l1)
    counted = moving_leaves(model.LEAVES, ref_start, ref_end)
    numbers["window_loss_gap"] = abs(prog_loss - ref_loss) / abs(ref_loss)
    numbers["window_change_gap"] = change_gap(model.LEAVES, start, prog_end, ref_start, ref_end, counted)
    return numbers


def eval_numbers(model, tables: Dict, graph, passes: List[Tuple[np.ndarray, np.ndarray]], n_entities: int,
                 n_relations: int, l1: bool, device) -> Dict[str, float]:
    """The eval number of the window's passes (each the program's (raw,
    filtered) ranks in its order: by relation, stably, for a grouped model)."""
    raw, filt = ref_ranks.ranks(model, tables, graph, n_entities, n_relations, l1, device)
    if model.GROUPED:
        order = np.argsort(ref_ranks.queries(graph["test"])["rel"], kind="stable")
        raw, filt = raw[order], filt[order]
    wrong = 0
    for p_raw, p_filt in passes:
        if p_raw.shape != raw.shape or p_filt.shape != filt.shape:
            wrong += raw.shape[0]
        else:
            wrong += int(((p_raw != raw) | (p_filt != filt)).sum())
    return {"rank_mismatch": wrong / (raw.shape[0] * max(len(passes), 1))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Whether every number that has a limit is within it, and each such
    number beside its limit.  A limit with no number fails."""
    shown = {name: {"value": numbers.get(name, float("nan")), "limit": limit} for name, limit in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
