"""PCRA relation-path extraction for PTransE (Lin et al., EMNLP'15).

Counterpart of ``kb2e_tpu/data/paths.py``, copied as it stands: host numpy
and Python, no device work.

The reference fork's README reports PTransE results (``README.md:26-29``,
survey §6) but ships none of its code (survey §0.1), so semantics follow the
paper the README descends from: for every training pair (h, t), enumerate
relation paths p = (r1, ..., rl) of length 2..L connecting h to t over the
train graph (augmented with inverse edges r+R), and weight each path by its
**path-constraint resource allocation** (PCRA) reliability: a unit resource
starts at h and at every hop splits uniformly over the tails reachable by
that hop's relation; R(p | h, t) is the resource arriving at t along p.

Path ids use the doubled relation vocabulary: ``v in [0, R)`` is the forward
relation v, ``v in [R, 2R)`` is the inverse of ``v − R``.

The pure-Python extractor below is the defining implementation (and the test
oracle); :mod:`kb2e_tpu_torch.data.native_paths` provides a C++ fast path with
identical output for production-scale graphs.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class PathStore(NamedTuple):
    """Per-TRIPLE padded path arrays (aligned with a TripleSet's triple order).

    ``rels``: int32 [T, P, L], doubled-vocabulary relation ids, −1 padding
    (both unused path slots and unused hops of short paths).
    ``conf``: float32 [T, P], PCRA reliability normalised per pair
    (R(p|h,t) / Z with Z = Σ over all discovered paths of the pair); 0 marks
    an unused path slot.
    """

    rels: np.ndarray
    conf: np.ndarray

    @property
    def max_paths(self) -> int:
        return self.rels.shape[1]

    @property
    def max_len(self) -> int:
        return self.rels.shape[2]

    def coverage(self) -> float:
        """Fraction of triples with at least one path."""
        return float((self.conf[:, 0] > 0).mean()) if self.conf.size else 0.0


def _grouped_adjacency(
    heads: np.ndarray, tails: np.ndarray, rels: np.ndarray, n_relations: int
) -> Dict[int, Dict[int, List[int]]]:
    """node -> {relation (doubled vocab) -> [targets]} with inverse edges."""
    out: Dict[int, Dict[int, List[int]]] = defaultdict(lambda: defaultdict(list))
    for h, t, r in zip(heads.tolist(), tails.tolist(), rels.tolist()):
        out[h][r].append(t)
        out[t][r + n_relations].append(h)
    return out


def extract_pair_paths(
    heads: np.ndarray,
    tails: np.ndarray,
    rels: np.ndarray,
    n_relations: int,
    max_len: int = 2,
    min_conf: float = 0.01,
    max_branch: int = 0,
    query_pairs: Tuple[np.ndarray, np.ndarray] | None = None,
) -> Dict[Tuple[int, int], List[Tuple[Tuple[int, ...], float]]]:
    """PCRA paths over the (heads, tails, rels) graph for each query pair.

    ``query_pairs`` defaults to the graph's own (h, t) pairs (training use);
    pass e.g. test pairs to extract evidence paths for evaluation over the
    train graph.  Returns pair -> list of (path, normalised confidence),
    confidence-sorted descending.  ``min_conf`` filters AFTER normalisation
    (Z includes every discovered path); ``max_branch`` > 0 skips expanding
    (node, relation) fan-outs larger than the cap — the standard truncation
    for hub nodes.
    """
    heads = np.asarray(heads)
    tails = np.asarray(tails)
    rels = np.asarray(rels)
    out = _grouped_adjacency(heads, tails, rels, n_relations)

    q_heads, q_tails = query_pairs if query_pairs is not None else (heads, tails)
    targets_by_head: Dict[int, set] = defaultdict(set)
    for h, t in zip(np.asarray(q_heads).tolist(), np.asarray(q_tails).tolist()):
        targets_by_head[h].add(t)

    result: Dict[Tuple[int, int], List[Tuple[Tuple[int, ...], float]]] = {}
    raw: Dict[Tuple[int, int], Dict[Tuple[int, ...], float]] = defaultdict(dict)

    for h, targets in targets_by_head.items():
        # frontier: path -> {node: resource}; starts with the empty path at h.
        frontier: Dict[Tuple[int, ...], Dict[int, float]] = {(): {h: 1.0}}
        for depth in range(1, max_len + 1):
            nxt: Dict[Tuple[int, ...], Dict[int, float]] = defaultdict(
                lambda: defaultdict(float)
            )
            for path, nodes in frontier.items():
                for n, res in nodes.items():
                    for rel, tgts in out[n].items():
                        fan = len(tgts)
                        if max_branch and fan > max_branch:
                            continue
                        share = res / fan
                        acc = nxt[path + (rel,)]
                        for g in tgts:
                            acc[g] += share
            frontier = {p: dict(nodes) for p, nodes in nxt.items()}
            if depth >= 2:  # length-1 "paths" are the direct relation itself
                for path, nodes in frontier.items():
                    for t in targets:
                        res = nodes.get(t)
                        if res:
                            raw[(h, t)][path] = raw[(h, t)].get(path, 0.0) + res

    for pair, paths in raw.items():
        z = sum(paths.values())
        kept = [(p, r / z) for p, r in paths.items() if r / z >= min_conf]
        kept.sort(key=lambda pr: (-pr[1], pr[0]))
        if kept:
            result[pair] = kept
    return result


def build_path_store(
    heads: np.ndarray,
    tails: np.ndarray,
    rels: np.ndarray,
    n_relations: int,
    max_len: int = 2,
    min_conf: float = 0.01,
    max_paths: int = 8,
    max_branch: int = 0,
    pair_paths: Dict[Tuple[int, int], List[Tuple[Tuple[int, ...], float]]] | None = None,
    use_native: "bool | str" = "auto",
    n_entities: int | None = None,
    query_pairs: Tuple[np.ndarray, np.ndarray] | None = None,
) -> PathStore:
    """Build padded path arrays, one row per query pair.

    Queries default to the graph's own triples (training store); pass test
    pairs via ``query_pairs`` to build an evaluation-evidence store.
    ``use_native``: True forces the C++ extractor, False the Python one,
    'auto' picks native for graphs above ~20k triples (where the Python
    dict-based PCRA becomes the bottleneck) when the toolchain is available.
    ``pair_paths`` lets callers inject externally computed paths.
    """
    q_heads, q_tails = query_pairs if query_pairs is not None else (heads, tails)
    if pair_paths is None and use_native is not False:
        want_native = use_native is True or (
            use_native == "auto" and len(heads) > 20_000
        )
        if want_native:
            from kb2e_tpu_torch.data import native_paths

            if native_paths.available():
                if n_entities is None:
                    n_entities = int(max(np.max(heads), np.max(tails))) + 1
                rels_arr, conf_arr = native_paths.extract_path_arrays(
                    heads, tails, rels, n_entities, n_relations,
                    max_len=max_len, min_conf=min_conf,
                    max_paths=max_paths, max_branch=max_branch,
                    query_pairs=(q_heads, q_tails),
                )
                return PathStore(rels=rels_arr, conf=conf_arr)
            if use_native is True:
                raise RuntimeError("native path extractor requested but unavailable")
    if pair_paths is None:
        pair_paths = extract_pair_paths(
            heads, tails, rels, n_relations,
            max_len=max_len, min_conf=min_conf, max_branch=max_branch,
            query_pairs=(q_heads, q_tails),
        )
    T = len(q_heads)
    path_rels = np.full((T, max_paths, max_len), -1, dtype=np.int32)
    path_conf = np.zeros((T, max_paths), dtype=np.float32)
    for i, (h, t) in enumerate(zip(np.asarray(q_heads).tolist(), np.asarray(q_tails).tolist())):
        plist = pair_paths.get((h, t))
        if not plist:
            continue
        for j, (p, c) in enumerate(plist[:max_paths]):
            path_rels[i, j, : len(p)] = p
            path_conf[i, j] = c
    return PathStore(rels=path_rels, conf=path_conf)
