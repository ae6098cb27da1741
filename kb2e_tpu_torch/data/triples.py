"""Triple store: loading, validation, bern statistics, sorted index.

Reference semantics reproduced here:

* ``loadTripleFile`` (``common/loader.cpp:26-62``): rows are
  ``head<TAB>tail<TAB>relation`` *string* ids; rows referencing unknown ids are
  warned about and skipped.
* bern corruption statistics (``common/trainer.cpp:171-194``): per relation,
  the mean co-occurrence counts hpt (heads-per-tail) and tph (tails-per-head);
  P(corrupt tail) = hpt / (hpt + tph) (survey quirk B8).
* known-triple set ``triples_[{h,r}][t]`` (``common/trainer.h:43-49``) —
  realised as a lexicographically sorted, deduplicated (h, r, t) index.

Triples are host-side struct-of-arrays int32; the modules that need them on
the card move them there.  The cuckoo membership index of the training
sampler is built by the trainer (``train/step.py::DeviceData``), not when the
set is made, so loading for evaluation does not pay for it.
:func:`load_dataset` parses with the C++ loader of ``data/native.py`` where it
builds, else with :func:`load_triple_file`.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from kb2e_tpu_torch import constants as C
from kb2e_tpu_torch.data import vocab


def load_triple_file(
    path: str,
    entity2id: Dict[str, int],
    relation2id: Dict[str, int],
    *,
    warn: Callable[[str], None] = lambda m: print(m, file=sys.stderr),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``head tail relation`` rows into int32 arrays.

    Matches ``loadTripleFile`` (common/loader.cpp:26-62): unknown ids are
    warned about and the row is skipped — training proceeds on the rest.
    """
    heads, tails, rels = [], [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                warn(f"Malformed triple row skipped: {line.rstrip()!r}")
                continue
            h, t, r = parts
            ok = True
            if h not in entity2id:
                warn(f"Head entity found in triple file that was not found in the identity file: {h}")
                ok = False
            if t not in entity2id:
                warn(f"Tail entity found in triple file that was not found in the identity file: {t}")
                ok = False
            if r not in relation2id:
                warn(f"Relation found in triple file that was not found in the identity file: {r}")
                ok = False
            if not ok:
                continue
            heads.append(entity2id[h])
            tails.append(entity2id[t])
            rels.append(relation2id[r])
    return (
        np.asarray(heads, dtype=np.int32),
        np.asarray(tails, dtype=np.int32),
        np.asarray(rels, dtype=np.int32),
    )


def bern_tail_probability(
    heads: np.ndarray, tails: np.ndarray, rels: np.ndarray, n_relations: int
) -> np.ndarray:
    """P(corrupt tail) per relation under bern sampling.

    Reference: ``common/trainer.cpp:171-194`` computes, per relation, the mean
    over distinct tails of the number of triples sharing that (relation, tail)
    — heads-per-tail (hpt) — and symmetrically tph; the sampling coin at
    ``common/trainer.cpp:82`` corrupts the tail with probability
    hpt/(hpt+tph).  Returns float64 [n_relations]; relations absent from the
    training set get 0.5 (uniform), where the reference divides 0 by 0.
    """
    hpt = np.zeros(n_relations, dtype=np.float64)
    tph = np.zeros(n_relations, dtype=np.float64)

    # heads-per-tail: mean over distinct (r, t) groups of group size.
    rt = np.stack([rels.astype(np.int64), tails.astype(np.int64)], axis=1)
    uniq_rt, counts_rt = np.unique(rt, axis=0, return_counts=True)
    if uniq_rt.size:
        group_sums = np.bincount(uniq_rt[:, 0], weights=counts_rt, minlength=n_relations)
        group_cnts = np.bincount(uniq_rt[:, 0], minlength=n_relations)
        nz = group_cnts > 0
        hpt[nz] = group_sums[nz] / group_cnts[nz]

    rh = np.stack([rels.astype(np.int64), heads.astype(np.int64)], axis=1)
    uniq_rh, counts_rh = np.unique(rh, axis=0, return_counts=True)
    if uniq_rh.size:
        group_sums = np.bincount(uniq_rh[:, 0], weights=counts_rh, minlength=n_relations)
        group_cnts = np.bincount(uniq_rh[:, 0], minlength=n_relations)
        nz = group_cnts > 0
        tph[nz] = group_sums[nz] / group_cnts[nz]

    denom = hpt + tph
    pr = np.full(n_relations, 0.5, dtype=np.float64)
    nz = denom > 0
    pr[nz] = hpt[nz] / denom[nz]
    return pr


@dataclasses.dataclass
class TripleSet:
    """Struct-of-arrays triple store plus derived indices.

    ``sorted_h/r/t`` hold the same triples sorted lexicographically by
    (h, r, t) and deduplicated — the membership index standing in for the
    reference's ``std::map`` known-triple set (common/trainer.h:43-49).
    """

    heads: np.ndarray  # int32 [T]
    tails: np.ndarray  # int32 [T]
    rels: np.ndarray  # int32 [T]
    n_entities: int
    n_relations: int
    bern_pr_tail: np.ndarray  # float64 [R], P(corrupt tail) per relation
    sorted_h: np.ndarray  # int32 [U]
    sorted_r: np.ndarray  # int32 [U]
    sorted_t: np.ndarray  # int32 [U]

    @property
    def num_triples(self) -> int:
        return int(self.heads.shape[0])

    @classmethod
    def from_arrays(
        cls,
        heads: np.ndarray,
        tails: np.ndarray,
        rels: np.ndarray,
        n_entities: int,
        n_relations: int,
        *,
        extra_filter: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    ) -> "TripleSet":
        """Build a TripleSet; ``extra_filter`` adds triples that participate in
        the membership index (e.g. valid+test for evaluation filtering,
        common/evaluation.cpp:55-61) but not in the working arrays."""
        heads = np.asarray(heads, dtype=np.int32)
        tails = np.asarray(tails, dtype=np.int32)
        rels = np.asarray(rels, dtype=np.int32)
        for name, arr, hi in (("head", heads, n_entities), ("tail", tails, n_entities), ("relation", rels, n_relations)):
            if arr.size and (arr.min() < 0 or arr.max() >= hi):
                raise ValueError(f"{name} ids out of range [0, {hi})")

        fh, ft, fr = heads, tails, rels
        if extra_filter is not None:
            eh, et, er = extra_filter
            fh = np.concatenate([fh, np.asarray(eh, np.int32)])
            ft = np.concatenate([ft, np.asarray(et, np.int32)])
            fr = np.concatenate([fr, np.asarray(er, np.int32)])

        # Lexicographic (h, r, t) sort + dedup for the membership index.
        order = np.lexsort((ft, fr, fh))
        sh, sr, st = fh[order], fr[order], ft[order]
        if sh.size:
            keep = np.ones(sh.shape[0], dtype=bool)
            keep[1:] = (sh[1:] != sh[:-1]) | (sr[1:] != sr[:-1]) | (st[1:] != st[:-1])
            sh, sr, st = sh[keep], sr[keep], st[keep]

        return cls(
            heads=heads,
            tails=tails,
            rels=rels,
            n_entities=n_entities,
            n_relations=n_relations,
            bern_pr_tail=bern_tail_probability(heads, tails, rels, n_relations),
            sorted_h=sh,
            sorted_r=sr,
            sorted_t=st,
        )


@dataclasses.dataclass
class Dataset:
    """A full data directory in reference layout (common/constants.h:19-23)."""

    entity2id: Dict[str, int]
    relation2id: Dict[str, int]
    train: TripleSet
    valid: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    test: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    @property
    def n_entities(self) -> int:
        return len(self.entity2id)

    @property
    def n_relations(self) -> int:
        return len(self.relation2id)


def load_dataset(
    data_dir: str,
    *,
    splits: Tuple[str, ...] = ("train",),
    filter_with_eval_splits: bool = False,
    use_native: bool = True,
) -> Dataset:
    """Load a reference-layout data directory.

    ``filter_with_eval_splits=True`` reproduces the evaluation harness's
    filter-set construction (test+train+valid all enter the known-good set,
    common/evaluation.cpp:55-61).

    ``use_native=True`` parses the triple files with the C++ loader
    (``data/native.py``) when it builds and loads, else with the Python
    parser; both give the same arrays.
    """
    loader = load_triple_file
    if use_native:
        from kb2e_tpu_torch.data import native

        if native.available():
            loader = native.load_triple_file

    entity2id = vocab.load_id_file(os.path.join(data_dir, C.ENTITY_ID_FILE))
    relation2id = vocab.load_id_file(os.path.join(data_dir, C.RELATION_ID_FILE))

    arrays = {}
    split_files = {"train": C.TRAIN_FILE, "valid": C.VALID_FILE, "test": C.TEST_FILE}
    for split in splits:
        path = os.path.join(data_dir, split_files[split])
        if os.path.exists(path):
            arrays[split] = loader(path, entity2id, relation2id)

    if "train" not in arrays:
        raise FileNotFoundError(f"missing {C.TRAIN_FILE} in {data_dir}")

    extra = None
    if filter_with_eval_splits:
        parts = [arrays[s] for s in ("valid", "test") if s in arrays]
        if parts:
            extra = tuple(np.concatenate([p[i] for p in parts]) for i in range(3))

    train = TripleSet.from_arrays(
        *arrays["train"],
        n_entities=len(entity2id),
        n_relations=len(relation2id),
        extra_filter=extra,
    )
    return Dataset(
        entity2id=entity2id,
        relation2id=relation2id,
        train=train,
        valid=arrays.get("valid"),
        test=arrays.get("test"),
    )
