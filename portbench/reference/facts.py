"""What the program derives from the graph, worked out again in plain NumPy.

The bern corruption probabilities (``common/trainer.cpp:171-194``: per
relation, heads-per-tail over heads-per-tail plus tails-per-head), the
membership of a triple in a set, and each eval query's known answers.
Nothing here reads anything the program made.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def keys(h, r, t, n_entities: int, n_relations: int) -> np.ndarray:
    """One int64 key per (h, r, t)."""
    return (np.asarray(h, np.int64) * n_relations + np.asarray(r, np.int64)) * n_entities + np.asarray(t, np.int64)


def bern_tail_probability(h, t, r, n_relations: int) -> np.ndarray:
    """float64 [R]: the chance that bern corrupts the tail of a triple of each
    relation, hpt / (hpt + tph); 0.5 for a relation with no triple.

    hpt is the mean, over the distinct (r, t) of a relation, of its triples'
    count; tph the same over the distinct (r, h)."""
    r = np.asarray(r, np.int64)

    def mean_group(other):
        m = int(np.max(other, initial=0)) + 1
        uniq, count = np.unique(r * m + np.asarray(other, np.int64), return_counts=True)
        rel = uniq // m
        groups = np.bincount(rel, minlength=n_relations)
        total = np.bincount(rel, weights=count, minlength=n_relations)
        return np.divide(total, groups, out=np.zeros(n_relations), where=groups > 0)

    hpt, tph = mean_group(t), mean_group(h)
    return np.divide(hpt, hpt + tph, out=np.full(n_relations, 0.5), where=(hpt + tph) > 0)


class Known:
    """The known answers of (anchor, relation) pairs: for a head query (t, r)
    the heads h with (h, r, t) in the set, for a tail query (h, r) the tails."""

    def __init__(self, h, t, r, n_entities: int, n_relations: int):
        self._n_rel = n_relations
        self._side = {}
        for side, anchor, answer in (("head", t, h), ("tail", h, t)):
            k = np.asarray(anchor, np.int64) * n_relations + np.asarray(r, np.int64)
            order = np.argsort(k, kind="stable")
            self._side[side] = (k[order], np.asarray(answer, np.int64)[order])

    def pairs(self, side: str, anchor: np.ndarray, rel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(query position, answer) of every known answer of the given queries."""
        sorted_keys, answers = self._side[side]
        q = np.asarray(anchor, np.int64) * self._n_rel + np.asarray(rel, np.int64)
        lo = np.searchsorted(sorted_keys, q, side="left")
        count = np.searchsorted(sorted_keys, q, side="right") - lo
        rows = np.repeat(np.arange(q.shape[0]), count)
        starts = np.repeat(lo - np.concatenate([[0], np.cumsum(count)[:-1]]), count)
        return rows, answers[starts + np.arange(rows.shape[0])]
