"""On-device batch sampling with unif/bern negative corruption.

Counterpart of ``kb2e_tpu/sampling/corruption.py``.  Reference flow per
sample (``common/trainer.cpp:78-98``):
  1. draw a random training triple i and a random entity j,
  2. flip the bern/unif coin — P(corrupt tail) = hpt/(hpt+tph) (bern,
     quirk B8) or 0.5 (unif),
  3. rejection-resample j until the corrupted triple is NOT a known triple.

The unbounded rejection loop becomes ``resample_rounds`` candidates drawn up
front and tested together against the membership index; the first
non-member wins, and samples with no non-member are flagged ``valid=False``
and masked out of the loss and the update.

The draws come from an explicit ``torch.Generator`` on the device of the
data, in the JAX package's order: the triple indices, then the coins, then
the [B, K, rounds] candidates.  Torch's generator does not give JAX's bits;
:func:`batch_from_streams` builds a batch from injected decisions, so tests
can drive both packages with the same ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from kb2e_tpu_torch.constants import Method
from kb2e_tpu_torch.models.base import Batch
from kb2e_tpu_torch.sampling import cuckoo, membership


def sample_batch(
    generator: torch.Generator,
    heads: torch.Tensor,  # int32 [T] training triples
    tails: torch.Tensor,
    rels: torch.Tensor,
    bern_pr_tail: torch.Tensor,  # float32 [R]
    sorted_h: torch.Tensor,  # binary-search membership index (fallback path)
    sorted_r: torch.Tensor,
    sorted_t: torch.Tensor,
    n_entities: int,
    batch_size: int,
    method: Method,
    resample_rounds: int = 8,
    cuckoo_table: Optional[torch.Tensor] = None,  # [2*M, 2] fast-path index
    cuckoo_m: int = 0,
    cuckoo_salt: int = 0,
    cuckoo_fp: Optional[torch.Tensor] = None,  # [2*M] fingerprint fast probe
    n_relations: int = 0,
    num_negatives: int = 1,
    return_idx: bool = False,
) -> Batch:
    """Draw one training batch: positives + certified-negative corruptions.

    ``num_negatives`` K > 1 draws K certified negatives per positive (all on
    the same corruption side — one coin per sample) and returns the batch
    flattened to B·K rows with the positives repeated sample-major (row
    b·K+j is sample b's j-th negative).  ``return_idx`` adds ``idx``, the
    index of each row's positive triple (repeated with it), for consumers
    with per-triple side data (PTransE's path store).
    """
    dev = heads.device
    n_triples = heads.shape[0]
    i = torch.randint(0, n_triples, (batch_size,), generator=generator, device=dev)
    ph, pt, r = heads[i], tails[i], rels[i]

    if Method.from_any(method) == Method.BERN:
        p_tail = bern_pr_tail[r].to(torch.float32)
    else:
        p_tail = torch.full((batch_size,), 0.5, dtype=torch.float32, device=dev)
    corrupt_tail = torch.rand(batch_size, generator=generator, device=dev) < p_tail

    kneg = max(1, num_negatives)
    cands = torch.randint(
        0, n_entities, (batch_size, kneg, max(1, resample_rounds)), generator=generator, device=dev
    ).to(torch.int32)
    ct = corrupt_tail[:, None, None]
    qh = torch.where(ct, ph[:, None, None], cands)
    qt = torch.where(ct, cands, pt[:, None, None])
    qr = r[:, None, None].expand(cands.shape)

    if cuckoo_fp is not None:
        bad = cuckoo.contains_fp(cuckoo_fp, cuckoo_m, cuckoo_salt, n_relations, qh, qr, qt)
    elif cuckoo_table is not None:
        bad = cuckoo.contains(cuckoo_table, cuckoo_m, cuckoo_salt, n_relations, qh, qr, qt)
    else:
        bad = membership.contains(sorted_h, sorted_r, sorted_t, qh, qr, qt)

    ok = ~bad
    # argmax takes no bool: the first certified negative per slot (0 if none).
    first = torch.argmax(ok.to(torch.int32), dim=2)
    valid = ok.any(dim=2)  # [B, K]
    j = torch.gather(cands, 2, first[..., None])[..., 0]  # [B, K]

    nh = torch.where(corrupt_tail[:, None], ph[:, None], j)
    nt = torch.where(corrupt_tail[:, None], j, pt[:, None])
    if kneg == 1:
        out = {"ph": ph, "pt": pt, "r": r, "nh": nh[:, 0], "nt": nt[:, 0], "valid": valid[:, 0]}
    else:
        rep = lambda x: torch.repeat_interleave(x, kneg)  # noqa: E731 — sample-major tiling
        out = {
            "ph": rep(ph), "pt": rep(pt), "r": rep(r),
            "nh": nh.reshape(-1), "nt": nt.reshape(-1), "valid": valid.reshape(-1),
        }
        i = rep(i)
    if return_idx:
        out["idx"] = i
    return out


def sample_relation_negatives(
    generator: torch.Generator,
    ph: torch.Tensor,  # [B] positive triple
    pt: torch.Tensor,
    r: torch.Tensor,
    n_relations: int,
    sorted_h: torch.Tensor,
    sorted_r: torch.Tensor,
    sorted_t: torch.Tensor,
    resample_rounds: int = 4,
    cuckoo_table: Optional[torch.Tensor] = None,
    cuckoo_m: int = 0,
    cuckoo_salt: int = 0,
    cuckoo_fp: Optional[torch.Tensor] = None,
):
    """Corrupted RELATIONS for PTransE's path loss (paper eq. 8: replace r
    with r′ such that (h, r′, t) is false), as
    ``kb2e_tpu/sampling/corruption.py::sample_relation_negatives``.

    The same fixed-rounds rejection as :func:`sample_batch`: ``resample_rounds``
    candidates [B, rounds] drawn at once, the first not known wins; the
    membership of (h, r, t) itself makes r′ ≠ r.  Returns (nr [B] int32,
    valid [B] bool).
    """
    batch_size = ph.shape[0]
    cands = torch.randint(0, n_relations, (batch_size, max(1, resample_rounds)), generator=generator,
                          device=ph.device).to(torch.int32)
    qh = ph[:, None].expand(cands.shape)
    qt = pt[:, None].expand(cands.shape)
    if cuckoo_fp is not None:
        bad = cuckoo.contains_fp(cuckoo_fp, cuckoo_m, cuckoo_salt, n_relations, qh, cands, qt)
    elif cuckoo_table is not None:
        bad = cuckoo.contains(cuckoo_table, cuckoo_m, cuckoo_salt, n_relations, qh, cands, qt)
    else:
        bad = membership.contains(sorted_h, sorted_r, sorted_t, qh, cands, qt)
    ok = ~bad
    first = torch.argmax(ok.to(torch.int32), dim=1)
    valid = ok.any(dim=1)
    nr = torch.gather(cands, 1, first[:, None])[:, 0]
    return nr, valid


def batch_from_streams(
    triple_idx: torch.Tensor,
    candidate_j: torch.Tensor,
    corrupt_tail: torch.Tensor,
    heads: torch.Tensor,
    tails: torch.Tensor,
    rels: torch.Tensor,
) -> Batch:
    """Build a batch from externally injected decision streams.

    The parity-test entry point: the same (triple index, corruption
    candidate, direction) stream drives this package, the JAX package and
    the host oracle, sidestepping RNG differences.  The caller guarantees
    the candidates are true negatives.
    """
    ph, pt, r = heads[triple_idx], tails[triple_idx], rels[triple_idx]
    candidate_j = candidate_j.to(ph.dtype)
    nh = torch.where(corrupt_tail, ph, candidate_j)
    nt = torch.where(corrupt_tail, candidate_j, pt)
    valid = torch.ones(ph.shape, dtype=torch.bool, device=ph.device)
    return {"ph": ph, "pt": pt, "r": r, "nh": nh, "nt": nt, "valid": valid}
