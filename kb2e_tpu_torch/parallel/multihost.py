"""Multi-process runtime: rendezvous, per-rank edge shards, global statistics.

Counterpart of ``kb2e_tpu/parallel/multihost.py``:

* :func:`initialize` — ``torch.distributed.init_process_group`` with a
  timeout, so that a rank whose peer died leaves its collective with an
  error instead of waiting forever;
* :func:`partition_edges` — each rank takes a contiguous shard of the edge
  list, wrap-padded to one common size; ``valid`` flags the padding;
* :func:`global_bern_stats` — the bern statistics of the *global* edge list,
  exactly: the ranks exchange their distinct-(relation, entity) group count
  maps and merge them (a group may span shards);
* :func:`allgather_edges` — the replicated global edge list from the shards;
* :func:`barrier`.

These move host numpy through a gloo group (the world group under gloo, a
second gloo group under NCCL), whatever backend training runs on.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kb2e_tpu_torch.data.triples import bern_tail_probability

# The gloo group of the host-side helpers (None: the world group is gloo).
_host_group = None
# Seconds after which a collective gives up (a peer that died).
TIMEOUT_S = 60


def initialize(
    coordinator_address: Optional[str],
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
    device="cpu",
) -> None:
    """Join the process group of ``num_processes`` ranks as rank ``process_id``.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there) or
    ``env://`` (``torchrun``'s variables).  The backend is NCCL for a CUDA
    ``device`` and gloo for the CPU unless ``backend`` says otherwise: the
    keyword is the only way to run gloo over CUDA tensors (two ranks on one
    card), and nothing falls back to it by itself.  Collectives give up after
    ``TIMEOUT_S`` seconds.  A no-op if the group exists already.
    """
    global _host_group
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _host_group = None if backend == "gloo" else dist.new_group(backend="gloo")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def partition_edges(
    heads: np.ndarray,
    tails: np.ndarray,
    rels: np.ndarray,
    process_id: int,
    num_processes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous shard ``process_id`` of the triple arrays, padded to the common
    size ceil(T / num_processes) by wrapping around the global list; returns
    ``(heads, tails, rels, valid)`` with ``valid`` False on the padding."""
    n = heads.shape[0]
    per_rank = -(-n // num_processes)
    pos = process_id * per_rank + np.arange(per_rank)
    valid = pos < n
    idx = pos % n
    return heads[idx], tails[idx], rels[idx], valid


def _local_group_counts(rels: np.ndarray, ents: np.ndarray, direction: int) -> np.ndarray:
    """Distinct-(relation, entity) group count map: int64 [G, 4] rows of
    (direction, relation, entity, count)."""
    pairs = np.stack([rels.astype(np.int64), ents.astype(np.int64)], 1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    out = np.empty((uniq.shape[0], 4), dtype=np.int64)
    out[:, 0] = direction
    out[:, 1:3] = uniq
    out[:, 3] = counts
    return out


def _stats_from_groups(groups: np.ndarray, n_relations: int) -> np.ndarray:
    """hpt / (hpt + tph) per relation from merged (direction, relation,
    entity, count) rows: ``data/triples.py::bern_tail_probability``'s math."""
    means = np.zeros((2, n_relations), dtype=np.float64)
    for d in range(2):
        g = groups[groups[:, 0] == d]
        if g.shape[0]:
            sums = np.bincount(g[:, 1], weights=g[:, 3].astype(np.float64), minlength=n_relations)
            cnts = np.bincount(g[:, 1], minlength=n_relations)
            nz = cnts > 0
            means[d, nz] = sums[nz] / cnts[nz]
    hpt, tph = means
    denom = hpt + tph
    pr = np.full(n_relations, 0.5)
    nz = denom > 0
    pr[nz] = hpt[nz] / denom[nz]
    return pr


def _allgather_ragged(rows: np.ndarray) -> np.ndarray:
    """Every rank's int64 [L, C] rows, in rank order: one gather of the
    lengths, then one of the rows padded to the longest."""
    world = process_count()
    length = torch.tensor([rows.shape[0]], dtype=torch.int64)
    lengths = [torch.zeros_like(length) for _ in range(world)]
    dist.all_gather(lengths, length, group=_host_group)
    lengths = [int(x) for x in lengths]
    padded = torch.full((max(lengths), rows.shape[1]), -1, dtype=torch.int64)
    padded[: rows.shape[0]] = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=_host_group)
    return np.concatenate([p[:n].numpy() for p, n in zip(parts, lengths)], axis=0)


def global_bern_stats(
    local_heads: np.ndarray,
    local_tails: np.ndarray,
    local_rels: np.ndarray,
    n_relations: int,
    valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """P(corrupt tail) per relation over the global edge list, exactly: the
    ranks' group count maps, gathered and merged by summing the counts of a
    group that spans shards.  ``valid`` masks :func:`partition_edges`'
    padding.  On one process: ``bern_tail_probability``."""
    if valid is not None:
        local_heads, local_tails, local_rels = local_heads[valid], local_tails[valid], local_rels[valid]
    if process_count() == 1:
        return bern_tail_probability(local_heads, local_tails, local_rels, n_relations)
    local = np.concatenate([
        _local_group_counts(local_rels, local_tails, direction=0),  # hpt groups
        _local_group_counts(local_rels, local_heads, direction=1),  # tph groups
    ])
    rows = _allgather_ragged(local)
    uniq, inv = np.unique(rows[:, :3], axis=0, return_inverse=True)
    counts = np.bincount(inv.reshape(-1), weights=rows[:, 3].astype(np.float64))
    return _stats_from_groups(np.concatenate([uniq, counts.astype(np.int64)[:, None]], axis=1), n_relations)


def allgather_edges(
    local_heads: np.ndarray,
    local_tails: np.ndarray,
    local_rels: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The global edge list (int32 heads, tails, relations) from every rank's
    shard, in rank order, without the padding; on one process the shard."""
    if valid is not None:
        local_heads, local_tails, local_rels = local_heads[valid], local_tails[valid], local_rels[valid]
    if process_count() == 1:
        return local_heads, local_tails, local_rels
    full = _allgather_ragged(np.stack([local_heads, local_tails, local_rels], axis=1).astype(np.int64))
    return tuple(full[:, i].astype(np.int32) for i in range(3))


def barrier() -> None:
    """Block until every rank reaches this point."""
    if process_count() > 1:
        dist.barrier(group=_host_group)
