"""Synthetic knowledge-graph generation.

The reference ships no data, so tests and ``chip_smoke.py`` run on generated
KGs: :func:`random_kg` draws uniform random triples, :func:`planted_kg`
samples them from a planted TransE ground truth (so learning shows in the
metrics), and :func:`write_kg_dir` writes them as a reference-layout
directory (entity2id.txt / relation2id.txt / train|valid|test.txt,
common/constants.h:19-23).  Same seed, same bytes as
``kb2e_tpu.data.synthetic``.  The skewed and compositional generators come
with the slices that need them.
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


def planted_kg(
    n_entities: int,
    n_relations: int,
    n_triples: int,
    seed: int = 0,
    latent_dim: int = 16,
    neighbourhood: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample triples from a planted translation structure.

    Entities get latent points z_e; relations get latent offsets z_r.  For a
    random (h, r), the tail is drawn from the ``neighbourhood`` nearest
    entities to z_h + z_r, so the KG is (approximately) realisable by TransE.
    """
    rng = np.random.default_rng(seed)
    z_e = rng.normal(size=(n_entities, latent_dim))
    z_e /= np.linalg.norm(z_e, axis=1, keepdims=True)
    z_r = 0.5 * rng.normal(size=(n_relations, latent_dim)) / np.sqrt(latent_dim)

    h = rng.integers(0, n_entities, n_triples)
    r = rng.integers(0, n_relations, n_triples)
    target = z_e[h] + z_r[r]  # [T, d]
    t = np.empty(n_triples, dtype=np.int64)
    if n_entities > 4000:
        # Large graphs: the matmul expansion d² = ‖q‖² + ‖z‖² − 2 q·z in
        # float32 keeps the temporary at [chunk, N] (+‖q‖² is rank-constant).
        ze32 = z_e.astype(np.float32)
        z_sq = np.sum(ze32 * ze32, axis=1)  # [N]
        chunk = 2048
        for s in range(0, n_triples, chunk):
            q = target[s : s + chunk].astype(np.float32)
            d2 = z_sq[None, :] - 2.0 * (q @ ze32.T)
            nn = np.argpartition(d2, neighbourhood, axis=1)[:, :neighbourhood]
            pick = rng.integers(0, neighbourhood, nn.shape[0])
            t[s : s + chunk] = nn[np.arange(nn.shape[0]), pick]
        return _dedup(h.astype(np.int32), t.astype(np.int32), r.astype(np.int32))
    chunk = 4096
    for s in range(0, n_triples, chunk):
        d = np.linalg.norm(target[s : s + chunk, None, :] - z_e[None, :, :], axis=-1)
        nn = np.argpartition(d, neighbourhood, axis=1)[:, :neighbourhood]
        pick = rng.integers(0, neighbourhood, nn.shape[0])
        t[s : s + chunk] = nn[np.arange(nn.shape[0]), pick]
    return _dedup(h.astype(np.int32), t.astype(np.int32), r.astype(np.int32))


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
