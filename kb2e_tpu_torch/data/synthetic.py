"""Synthetic knowledge-graph generation.

The reference ships no data, so tests and ``chip_smoke.py`` run on generated
KGs: :func:`random_kg` draws uniform random triples and :func:`write_kg_dir`
writes them as a reference-layout directory (entity2id.txt / relation2id.txt
/ train|valid|test.txt, common/constants.h:19-23).  Same seed, same bytes as
``kb2e_tpu.data.synthetic``.  The planted, skewed and compositional
generators come with the slices that need them.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from kb2e_tpu_torch.data import vocab


def _dedup(h: np.ndarray, t: np.ndarray, r: np.ndarray):
    """Drop duplicate (h, r, t) triples, keeping first occurrence order."""
    key = np.stack([h.astype(np.int64), r.astype(np.int64), t.astype(np.int64)], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    keep = np.sort(first)
    return h[keep], t[keep], r[keep]


def random_kg(
    n_entities: int,
    n_relations: int,
    n_triples: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    h = rng.integers(0, n_entities, n_triples).astype(np.int32)
    t = rng.integers(0, n_entities, n_triples).astype(np.int32)
    r = rng.integers(0, n_relations, n_triples).astype(np.int32)
    return _dedup(h, t, r)


def write_kg_dir(
    out_dir: str,
    triples: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n_entities: int,
    n_relations: int,
    *,
    split: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 0,
    entity_prefix: str = "e",
    relation_prefix: str = "r",
) -> None:
    """Write a reference-layout data directory with train/valid/test splits."""
    os.makedirs(out_dir, exist_ok=True)
    entity2id = {f"{entity_prefix}{i}": i for i in range(n_entities)}
    relation2id = {f"{relation_prefix}{i}": i for i in range(n_relations)}
    vocab.write_id_file(os.path.join(out_dir, "entity2id.txt"), entity2id)
    vocab.write_id_file(os.path.join(out_dir, "relation2id.txt"), relation2id)

    h, t, r = triples
    n = h.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(n * split[0])
    n_valid = int(n * split[1])
    parts = {
        "train.txt": perm[:n_train],
        "valid.txt": perm[n_train : n_train + n_valid],
        "test.txt": perm[n_train + n_valid :],
    }
    inv_e = {i: k for k, i in entity2id.items()}
    inv_r = {i: k for k, i in relation2id.items()}
    for fname, idx in parts.items():
        with open(os.path.join(out_dir, fname), "w", encoding="utf-8") as f:
            for i in idx:
                # Reference row order is head, tail, relation (common/loader.cpp:35).
                f.write(f"{inv_e[int(h[i])]}\t{inv_e[int(t[i])]}\t{inv_r[int(r[i])]}\n")
