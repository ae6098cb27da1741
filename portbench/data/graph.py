"""A seeded knowledge graph at a published graph's counts, with Zipf skew.

FB15k itself is not in the repository and cannot be fetched, so the cells
run on a graph drawn from ``--seed`` at its published counts (entities,
relations, train / valid / test triples).  The draws keep the statistics of
``kb2e_tpu_torch/data/synthetic.py::skewed_kg``: entity popularity and
relation sizes follow Zipf(``zipf_alpha``), and each relation is 1-1, 1-N,
N-1 or N-N (``type_mix``), a one-sided relation drawing that side from a pool
``fan`` times smaller.  That skew is what makes the update's scatter collide
on hub rows, gives bern sampling its signal and makes the eval's relation
groups uneven.  Unlike ``skewed_kg`` there is no planted structure (no
nearest-neighbour search for tails, which took minutes at this size): every
draw is vectorised, and the benchmark measures speed and agreement with its
reference, not quality.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Triples = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (heads, tails, rels), int32


def _zipf_weights(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    """Zipf(alpha) weights over n items, shuffled so that ids carry no rank."""
    w = rng.permutation(1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha)
    return w / w.sum()


def _draw(n_entities: int, n_relations: int, n_triples: int, alpha: float, fan: int, type_mix,
          rng: np.random.Generator) -> np.ndarray:
    """Packed (h, r, t) keys of about ``n_triples`` draws, duplicates included."""
    pop = _zipf_weights(n_entities, alpha, rng)
    sizes = np.maximum(1, np.round(_zipf_weights(n_relations, alpha, rng) * n_triples)).astype(np.int64)
    types = rng.choice(4, size=n_relations, p=np.asarray(type_mix, dtype=np.float64))  # 1-1, 1-N, N-1, N-N
    heads = np.where(types == 1, np.maximum(1, sizes // fan), sizes)
    tails = np.where(types == 2, np.maximum(1, sizes // fan), sizes)
    both = types == 3
    heads[both] = tails[both] = np.maximum(2, sizes[both] // 2)
    # Each relation's pools, drawn by popularity (with replacement), laid end to end.
    head_pool = rng.choice(n_entities, size=int(heads.sum()), p=pop)
    tail_pool = rng.choice(n_entities, size=int(tails.sum()), p=pop)
    head_off = np.concatenate([[0], np.cumsum(heads)[:-1]])
    tail_off = np.concatenate([[0], np.cumsum(tails)[:-1]])
    rel = np.repeat(np.arange(n_relations, dtype=np.int64), sizes)
    h = head_pool[head_off[rel] + (rng.random(rel.shape[0]) * heads[rel]).astype(np.int64)]
    t = tail_pool[tail_off[rel] + (rng.random(rel.shape[0]) * tails[rel]).astype(np.int64)]
    return (h * n_relations + rel) * n_entities + t


def generate(spec: Dict, seed: int) -> Dict[str, Triples]:
    """{"train", "valid", "test"}: distinct triples at ``spec``'s counts.

    ``spec`` holds ``n_entities``, ``n_relations``, ``n_train``, ``n_valid``,
    ``n_test``, ``zipf_alpha``, ``fan`` and ``type_mix``.  The same seed gives
    the same graph.  Draws are repeated with more triples until enough are
    distinct; the distinct triples are then shuffled and cut into the three
    splits, so no triple is in two splits.
    """
    n_ent, n_rel = int(spec["n_entities"]), int(spec["n_relations"])
    counts = [int(spec[f"n_{split}"]) for split in ("train", "valid", "test")]
    need = sum(counts)
    rng = np.random.default_rng(seed)
    draws = need
    while True:
        keys = np.unique(_draw(n_ent, n_rel, draws, float(spec["zipf_alpha"]), int(spec["fan"]),
                               spec["type_mix"], rng))
        if keys.shape[0] >= need:
            break
        draws = int(draws * 1.1 * need / max(keys.shape[0], 1))
    keys = rng.permutation(keys)[:need]
    t = (keys % n_ent).astype(np.int32)
    r = (keys // n_ent % n_rel).astype(np.int32)
    h = (keys // (n_ent * n_rel)).astype(np.int32)
    out, start = {}, 0
    for split, n in zip(("train", "valid", "test"), counts):
        out[split] = (h[start:start + n], t[start:start + n], r[start:start + n])
        start += n
    return out


def statistics(graph: Dict[str, Triples], n_entities: int, n_relations: int) -> Dict[str, int]:
    """The skew of a graph: relation sizes and the top entity degree, over all splits."""
    h, t, r = (np.concatenate([graph[s][i] for s in ("train", "valid", "test")]) for i in range(3))
    sizes = np.bincount(r, minlength=n_relations)
    degree = np.bincount(h, minlength=n_entities) + np.bincount(t, minlength=n_entities)
    return {"relation_size_min": int(sizes.min()), "relation_size_median": int(np.median(sizes)),
            "relation_size_max": int(sizes.max()), "top_entity_degree": int(degree.max())}
