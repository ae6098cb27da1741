"""Which parameter is cut over which mesh axis (counterpart of ``kb2e_tpu/parallel/sharding.py``).

A spec names, per axis of a table, the mesh axis that cuts it, or None:

* entity [N, k]             — rows over ``model`` (the big table; rank r
                              holds ``Mesh.entity_rows``),
* relation, norm [R, k]     — replicated,
* relation_inv, comp_w      — replicated (PTransE's small tables),
* proj [R, k, k], relation_c and centers [R, C, k] — replicated.  The JAX
  package cuts these over ``model`` on the relation axis; the port does not
  yet, and its spec says what it does.

Batches are cut over ``data``: each rank of a column scores its contiguous
share (``parallel/dist_step.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from kb2e_tpu_torch.parallel.mesh import Mesh

PARAM_SPECS: Dict[str, Tuple] = {
    "entity": ("model", None),
    "relation": (None, None),
    "norm": (None, None),
    "proj": (None, None, None),
    "relation_c": (None, None, None),
    "centers": (None, None, None),
    "relation_inv": (None, None),
    "comp_w": (None, None),
}


def local_rows(mesh: Mesh, table: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's rows of an entity-sharded table: ``table`` itself when it
    already is the shard (fewer than ``n`` rows), else its ``entity_rows`` slice."""
    row0, row1 = mesh.entity_rows(n)
    if table.shape[0] == n:
        return table[row0:row1]
    if table.shape[0] != row1 - row0:
        raise ValueError(f"entity table of {table.shape[0]} rows is neither all {n} rows nor this rank's "
                         f"{row1 - row0} ({row0}:{row1})")
    return table


def place_params(mesh: Mesh, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each table on the mesh's device, the entity table cut to this rank's
    rows (every rank starts from the same full tables)."""
    out = {}
    for key, value in params.items():
        value = value.to(mesh.device)
        if PARAM_SPECS[key][:1] == ("model",) and mesh.shape["model"] > 1:
            value = local_rows(mesh, value, value.shape[0]).clone()
        out[key] = value
    return out


def owned_rows(mesh: Mesh, shard: torch.Tensor, idx: torch.Tensor, row0: int) -> torch.Tensor:
    """Global rows ``idx`` (any shape) of a table whose rows ``[row0, row0 +
    len(shard))`` this rank holds: the owner adds each row, every other rank
    adds 0, and one ``all_reduce`` over ``model`` assembles them.  Exact:
    every row has one owner and x + 0 = x."""
    li = idx.to(torch.int64) - row0
    owned = (li >= 0) & (li < shard.shape[0])
    if shard.shape[0] == 0:
        rows = shard.new_zeros((*idx.shape, *shard.shape[1:]))
    else:
        rows = shard[li.clamp(0, shard.shape[0] - 1)]
        rows = torch.where(owned.reshape(*owned.shape, *([1] * (shard.dim() - 1))), rows, 0.0)
    return mesh.all_reduce(rows.contiguous(), "model")


def gather_params(mesh: Mesh, params: Dict[str, torch.Tensor], n_entities: int) -> Dict[str, torch.Tensor]:
    """The full tables on every rank: each cut table assembled from its
    owners (one ``all_reduce`` over ``model``); the replicated ones as they are."""
    out = dict(params)
    if mesh.shape["model"] > 1:
        row0, row1 = mesh.entity_rows(n_entities)
        shard = params["entity"]
        full = shard.new_zeros((n_entities, *shard.shape[1:]))
        full[row0:row1] = shard
        out["entity"] = mesh.all_reduce(full, "model")
    return out
