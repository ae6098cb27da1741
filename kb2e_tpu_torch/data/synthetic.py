"""Synthetic knowledge-graph generation.

The reference ships no data, so tests and ``chip_smoke.py`` run on generated
KGs: :func:`random_kg` draws uniform random triples, :func:`planted_kg`
samples them from a planted TransE ground truth (so learning shows in the
metrics), :func:`skewed_kg` adds FB15k's skew (Zipf-popular entities and
relations, a mix of 1-1, 1-N, N-1 and N-N relations), and
:func:`write_kg_dir` writes them as a reference-layout
directory (entity2id.txt / relation2id.txt / train|valid|test.txt,
common/constants.h:19-23).  :func:`compositional_kg` plants relation
compositions with 2-hop witnesses and a controlled split, the graph on which
PTransE's path evidence has signal.  Same seed, same bytes as
``kb2e_tpu.data.synthetic``.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import NamedTuple, Tuple

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

        def nearest(s: int) -> np.ndarray:
            q = target[s : s + chunk].astype(np.float32)
            d2 = z_sq[None, :] - 2.0 * (q @ ze32.T)
            return np.argpartition(d2, neighbourhood, axis=1)[:, :neighbourhood]

        # The searches draw nothing, so they run on threads (numpy leaves the
        # GIL in the product and the partition: 236 chunks at FB15k's shape
        # take minutes on one core); the picks are drawn in chunk order, as
        # kb2e_tpu's loop draws them.
        starts = range(0, n_triples, chunk)
        with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for s, nn in zip(starts, pool.map(nearest, starts)):
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


def skewed_kg(
    n_entities: int,
    n_relations: int,
    n_triples: int,
    seed: int = 0,
    latent_dim: int = 16,
    neighbourhood: int = 4,
    zipf_alpha: float = 0.8,
    fan: int = 6,
    type_mix: Tuple[float, float, float, float] = (0.15, 0.25, 0.30, 0.30),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FB15k-statistics-matched synthetic KG (planted + skewed).

    The planted KG validates model ordering but has near-uniform degree;
    real KGs don't.  This generator shapes the two statistics the reference's
    machinery exists FOR:

    * **Power-law popularity**: entity endpoint draws and per-relation triple
      counts follow a Zipf(``zipf_alpha``) law, giving heavy-tailed degrees.
    * **Relation cardinality mix**: each relation is assigned a type from
      ``type_mix`` = (1-1, 1-N, N-1, N-N) fractions (FB15k's measured mix is
      roughly 24/23/29/24; the default over-weights the N-sides bern sampling
      targets, common/trainer.cpp:171-194).  A 1-N relation draws heads from
      a pool ``fan``× smaller than its tails, so tph ≫ 1 and bern's
      corrupt-the-head preference has signal; N-1 mirrors it.

    Tails keep the planted-TransE structure: t is a near-neighbour of
    z_h + z_r *within the relation's tail pool*, so translation models can
    realise the graph and quality ordering stays meaningful.
    """
    rng = np.random.default_rng(seed)
    z_e = rng.normal(size=(n_entities, latent_dim))
    z_e /= np.linalg.norm(z_e, axis=1, keepdims=True)
    z_r = 0.5 * rng.normal(size=(n_relations, latent_dim)) / np.sqrt(latent_dim)

    # Zipf popularity over entities (shuffled so id order carries no signal).
    pop = (1.0 / np.arange(1, n_entities + 1) ** zipf_alpha)
    pop = rng.permutation(pop)
    pop /= pop.sum()

    # Zipf-ish triple counts per relation.
    rel_w = 1.0 / np.arange(1, n_relations + 1) ** zipf_alpha
    rel_w = rng.permutation(rel_w)
    counts = np.maximum(1, np.round(rel_w / rel_w.sum() * n_triples).astype(np.int64))

    types = rng.choice(4, size=n_relations, p=np.asarray(type_mix))

    hs, ts_, rs = [], [], []
    for rel in range(n_relations):
        m = int(counts[rel])
        ty = types[rel]  # 0: 1-1, 1: 1-N, 2: N-1, 3: N-N
        n_heads = max(1, m // fan) if ty in (1,) else m
        n_tails = max(1, m // fan) if ty in (2,) else m
        if ty == 3:  # N-N: both sides moderately pooled
            n_heads = max(2, m // 2)
            n_tails = max(2, m // 2)
        head_pool = rng.choice(n_entities, size=min(n_heads, n_entities), replace=False, p=pop)
        tail_pool = rng.choice(n_entities, size=min(n_tails, n_entities), replace=False, p=pop)
        h = head_pool[rng.integers(0, head_pool.shape[0], m)]
        # Planted tails: nearest members of the tail pool to z_h + z_r.
        target = z_e[h] + z_r[rel]  # [m, d]
        # A 1-N head repeats ~fan times and needs ≥ fan DISTINCT tails or the
        # dedup collapses its fan-out (and tph with it); a 1-1 relation wants
        # the single nearest tail so fan-out stays ≈ 1 on both sides.
        j = {0: 1, 1: 3 * fan, 2: neighbourhood, 3: 2 * fan}[int(ty)]
        j = min(j, tail_pool.shape[0])
        pick = rng.integers(0, j, m)
        # Nearest-neighbour search in fixed-size chunks of heads: the dense
        # [m, pool] distance matrix is multi-GB for the Zipf-head relation at
        # FB15k triple counts; chunking keeps peak memory at O(chunk × pool).
        pool_z = z_e[tail_pool]  # [pool, d]
        t = np.empty(m, dtype=np.int64)
        chunk = 2048
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            d = np.linalg.norm(target[lo:hi, None, :] - pool_z[None, :, :], axis=-1)
            nn = np.argpartition(d, j - 1, axis=1)[:, :j]
            t[lo:hi] = tail_pool[nn[np.arange(hi - lo), pick[lo:hi]]]
        hs.append(h)
        ts_.append(t)
        rs.append(np.full(m, rel, dtype=np.int64))

    h = np.concatenate(hs).astype(np.int32)
    t = np.concatenate(ts_).astype(np.int32)
    r = np.concatenate(rs).astype(np.int32)
    perm = rng.permutation(h.shape[0])
    return _dedup(h[perm], t[perm], r[perm])


class CompositionalKG(NamedTuple):
    """A KG with planted relation compositions and a CONTROLLED split.

    ``train``/``valid``/``test``: (h, t, r) triple arrays.  All base-relation
    edges live in train; composed-relation triples are mostly held out so
    their direct embeddings are under-trained while their 2-hop path
    witnesses stay in the train graph — the regime where PTransE's path
    evidence has signal to carry (Lin et al. EMNLP'15 §1; reference
    README.md:26-29 reports the resulting FB15k gains but the fork ships no
    code, survey §0.1).
    ``comp_pairs``: int32 [C, 2] — composed relation ``n_base + i`` is
    planted as ``comp_pairs[i, 0] ∘ comp_pairs[i, 1]``.
    """

    train: Tuple[np.ndarray, np.ndarray, np.ndarray]
    valid: Tuple[np.ndarray, np.ndarray, np.ndarray]
    test: Tuple[np.ndarray, np.ndarray, np.ndarray]
    n_entities: int
    n_base_relations: int
    n_composed: int
    comp_pairs: np.ndarray

    @property
    def n_relations(self) -> int:
        return self.n_base_relations + self.n_composed


def compositional_kg(
    n_entities: int = 2000,
    n_base_relations: int = 12,
    n_composed: int = 8,
    n_chains: int = 8000,
    n_extra_base: int = 8000,
    seed: int = 0,
    latent_dim: int = 16,
    neighbourhood: int = 4,
    direct_frac: float = 0.10,
    valid_frac: float = 0.10,
) -> CompositionalKG:
    """Plant relation compositions r_c ≡ r_a ∘ r_b WITH entity support.

    Construction: entities get latent points (planted-TransE style); each
    composed relation ``c`` picks a base pair (a, b) and its latent offset
    is z_a + z_b.  Every composed triple is emitted as a CHAIN — three
    triples (h, a, m), (m, b, t), (h, c, t) with m drawn near z_h + z_a and
    t near z_m + z_b — so each composed fact has an explicit 2-hop witness
    (h →a m →b t) in the train graph by construction.  ``n_extra_base``
    additional plain base edges act as path noise.

    Split: ALL base edges → train; composed triples → ``direct_frac`` into
    train (the under-trained direct evidence), the rest split valid/test.
    Statistics are pinned in kb2e_tpu's tests/test_data.py; same seed, same
    arrays as ``kb2e_tpu.data.synthetic.compositional_kg``.
    """
    rng = np.random.default_rng(seed)
    z_e = rng.normal(size=(n_entities, latent_dim))
    z_e /= np.linalg.norm(z_e, axis=1, keepdims=True)
    z_r = 0.5 * rng.normal(size=(n_base_relations, latent_dim)) / np.sqrt(latent_dim)

    # Composed pairs: distinct (a, b) base pairs, a != b.
    pairs = set()
    while len(pairs) < n_composed:
        a, b = rng.integers(0, n_base_relations, 2)
        if a != b:
            pairs.add((int(a), int(b)))
    comp_pairs = np.asarray(sorted(pairs), dtype=np.int32)

    def nearest(target: np.ndarray) -> np.ndarray:
        """Planted tail draw: one of the ``neighbourhood`` nearest entities."""
        t = np.empty(target.shape[0], dtype=np.int64)
        chunk = 4096
        for s in range(0, target.shape[0], chunk):
            d = np.linalg.norm(
                target[s : s + chunk, None, :] - z_e[None, :, :], axis=-1
            )
            nn = np.argpartition(d, neighbourhood, axis=1)[:, :neighbourhood]
            pick = rng.integers(0, neighbourhood, nn.shape[0])
            t[s : s + chunk] = nn[np.arange(nn.shape[0]), pick]
        return t

    # Chains: (h, a, m), (m, b, t), (h, c, t).
    ci = rng.integers(0, n_composed, n_chains)
    a, b = comp_pairs[ci, 0], comp_pairs[ci, 1]
    h = rng.integers(0, n_entities, n_chains)
    m = nearest(z_e[h] + z_r[a])
    t = nearest(z_e[m] + z_r[b])

    base_h = np.concatenate([h, m])
    base_t = np.concatenate([m, t])
    base_r = np.concatenate([a, b])

    # Extra plain base edges (path noise + base-relation training signal).
    eh = rng.integers(0, n_entities, n_extra_base)
    er = rng.integers(0, n_base_relations, n_extra_base)
    et = nearest(z_e[eh] + z_r[er])
    base_h = np.concatenate([base_h, eh])
    base_t = np.concatenate([base_t, et])
    base_r = np.concatenate([base_r, er])
    base_h, base_t, base_r = _dedup(
        base_h.astype(np.int32), base_t.astype(np.int32), base_r.astype(np.int32)
    )

    comp_h, comp_t = h.astype(np.int32), t.astype(np.int32)
    comp_r = (n_base_relations + ci).astype(np.int32)
    comp_h, comp_t, comp_r = _dedup(comp_h, comp_t, comp_r)

    # Controlled split of the composed triples.
    n_comp = comp_h.shape[0]
    perm = rng.permutation(n_comp)
    n_direct = int(n_comp * direct_frac)
    n_valid = int(n_comp * valid_frac)
    direct = perm[:n_direct]
    valid_i = perm[n_direct : n_direct + n_valid]
    test_i = perm[n_direct + n_valid :]

    train = (
        np.concatenate([base_h, comp_h[direct]]),
        np.concatenate([base_t, comp_t[direct]]),
        np.concatenate([base_r, comp_r[direct]]),
    )
    shuf = rng.permutation(train[0].shape[0])
    train = tuple(x[shuf] for x in train)
    return CompositionalKG(
        train=train,
        valid=(comp_h[valid_i], comp_t[valid_i], comp_r[valid_i]),
        test=(comp_h[test_i], comp_t[test_i], comp_r[test_i]),
        n_entities=n_entities,
        n_base_relations=n_base_relations,
        n_composed=n_composed,
        comp_pairs=comp_pairs,
    )


def split_in_order(
    triples: Tuple[np.ndarray, np.ndarray, np.ndarray], test_frac: float = 0.05
) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]:
    """(train, valid, test) of ``triples`` in their order, as
    ``benchmarks/quality_fb15k_scale.py`` cuts its planted KG: the last
    ``int(n * test_frac)`` triples are the test split, as many before them
    the valid split, and the rest the train split."""
    n = triples[0].shape[0]
    n_test = int(n * test_frac)
    cuts = (0, n - 2 * n_test, n - n_test, n)
    return tuple(tuple(a[lo:hi] for a in triples) for lo, hi in zip(cuts, cuts[1:]))


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
    n = triples[0].shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(n * split[0])
    n_valid = int(n * split[1])
    parts = (perm[:n_train], perm[n_train : n_train + n_valid], perm[n_train + n_valid :])
    write_split_dir(out_dir, *(tuple(a[idx] for a in triples) for idx in parts), n_entities, n_relations,
                    entity_prefix=entity_prefix, relation_prefix=relation_prefix)


def write_split_dir(
    out_dir: str,
    train: Tuple[np.ndarray, np.ndarray, np.ndarray],
    valid: Tuple[np.ndarray, np.ndarray, np.ndarray],
    test: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n_entities: int,
    n_relations: int,
    *,
    entity_prefix: str = "e",
    relation_prefix: str = "r",
) -> None:
    """Write a reference-layout data directory of the given (h, t, r) splits."""
    os.makedirs(out_dir, exist_ok=True)
    entity2id = {f"{entity_prefix}{i}": i for i in range(n_entities)}
    relation2id = {f"{relation_prefix}{i}": i for i in range(n_relations)}
    vocab.write_id_file(os.path.join(out_dir, "entity2id.txt"), entity2id)
    vocab.write_id_file(os.path.join(out_dir, "relation2id.txt"), relation2id)
    for fname, (h, t, r) in (("train.txt", train), ("valid.txt", valid), ("test.txt", test)):
        with open(os.path.join(out_dir, fname), "w", encoding="utf-8") as f:
            for a, b, c in zip(h.tolist(), t.tolist(), r.tolist()):
                # Reference row order is head, tail, relation (common/loader.cpp:35).
                f.write(f"{entity_prefix}{a}\t{entity_prefix}{b}\t{relation_prefix}{c}\n")
