"""Judges the training batches the program's sampler drew.

Every row is a positive triple of the train split and a corrupted triple of
the same relation.  A row the sampler marked valid must have exactly one
side replaced and must not be a triple of the train split.  Over the rows,
the tail side is replaced as often as bern's probabilities (worked out again
here from the train split) say: the count of tail replacements, less its
expectation, over its standard deviation, is a z-score near 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import facts


def judge(epochs: List[Dict], train, n_entities: int, n_relations: int, negatives: int, rows: int,
          device) -> Dict[str, float]:
    """``epochs``: each epoch's batches as the sampler drew them; their first
    ``rows`` rows, flattened, are the real ones (a chunked epoch pads the
    rest).  Returns the count of bad rows and bern's z-score."""
    known = torch.as_tensor(np.unique(facts.keys(train[0], train[2], train[1], n_entities, n_relations)),
                            device=device)
    bern = torch.as_tensor(facts.bern_tail_probability(train[0], train[1], train[2], n_relations), device=device)

    def member(h, r, t):
        key = (h.long() * n_relations + r.long()) * n_entities + t.long()
        at = torch.searchsorted(known, key).clamp(max=known.numel() - 1)
        return known[at] == key

    bad, tails, expected, variance = 0, 0.0, 0.0, 0.0
    for batches in epochs:
        b = {key: v.reshape(-1)[:rows] for key, v in batches.items()}
        valid = b["valid"]
        one_side = (b["nh"] != b["ph"]) ^ (b["nt"] != b["pt"])
        wrong = ~member(b["ph"], b["r"], b["pt"]) | (valid & (member(b["nh"], b["r"], b["nt"]) | ~one_side))
        bad += int(wrong.sum())
        # One coin per positive: its first row of ``negatives``.
        first = {key: v[::negatives] for key, v in b.items()}
        p = bern[first["r"].long()][first["valid"]].double()
        tails += float((first["nt"] != first["pt"])[first["valid"]].sum())
        expected += float(p.sum())
        variance += float((p * (1 - p)).sum())
    return {"bad_negatives": float(bad), "bern_z": abs(tails - expected) / max(variance, 1e-12) ** 0.5}
