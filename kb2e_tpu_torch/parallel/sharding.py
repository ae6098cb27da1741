"""Which parameter is cut over which mesh axis (counterpart of ``kb2e_tpu/parallel/sharding.py``).

A spec names, per axis of a table, the mesh axis that cuts it, or None:

* entity [N, k]             — rows over ``model`` (the big table; rank r
                              holds ``Mesh.entity_rows``),
* proj [R, k, k]            — TransR's and CTransR's matrices, over ``model``
                              on the relation axis (the other big table: 53.8
                              MB at FB15k's shape; rank r holds
                              ``Mesh.relation_rows``),
* relation_c, centers [R, C, k] — CTransR's cluster vectors and centers, cut
                              as ``proj``,
* relation, norm [R, k]     — replicated,
* relation_inv, comp_w      — replicated (PTransE's small tables).

These are the JAX package's specs.  A rank reads a row it does not hold from
its owner (:func:`owned_rows`, :func:`owned_tables`); the full tables, for
checkpoints and files, come from :func:`gather_params`.  Batches are cut over
``data``: each rank of a column scores its contiguous share
(``parallel/dist_step.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from kb2e_tpu_torch.parallel.mesh import Mesh

PARAM_SPECS: Dict[str, Tuple] = {
    "entity": ("model", None),
    "relation": (None, None),
    "norm": (None, None),
    "proj": ("model", None, None),
    "relation_c": ("model", None, None),
    "centers": ("model", None, None),
    "relation_inv": (None, None),
    "comp_w": (None, None),
}
# The tables cut on the relation axis.
RELATION_KEYS = tuple(key for key, spec in PARAM_SPECS.items() if spec[0] == "model" and key != "entity")


def _cut(table: torch.Tensor, n: int, bounds, what: str) -> torch.Tensor:
    """This rank's ``bounds`` rows of ``table``: a slice of the whole table
    (``n`` rows), or ``table`` itself when it already is the cut."""
    row0, row1 = bounds
    if table.shape[0] == n:
        return table[row0:row1]
    if table.shape[0] != row1 - row0:
        raise ValueError(f"{what} table of {table.shape[0]} rows is neither all {n} rows nor this rank's "
                         f"{row1 - row0} ({row0}:{row1})")
    return table


def local_rows(mesh: Mesh, table: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's rows of an entity-sharded table: ``table`` itself when it
    already is the shard, else its ``entity_rows`` slice."""
    return _cut(table, n, mesh.entity_rows(n), "entity")


def local_relations(mesh: Mesh, table: torch.Tensor, r: int) -> torch.Tensor:
    """This rank's relations of a table cut on the relation axis: ``table``
    itself when it already is the cut, else its ``relation_rows`` slice."""
    return _cut(table, r, mesh.relation_rows(r), "relation-cut")


def rows_of(mesh: Mesh, key: str, n: int):
    """[row0, row1): the rows of ``n`` this rank holds of the cut table ``key``."""
    return mesh.entity_rows(n) if key == "entity" else mesh.relation_rows(n)


def place_params(mesh: Mesh, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each table on the mesh's device, each cut table cut to this rank's
    rows on its own axis (every rank starts from the same full tables)."""
    out = {}
    for key, value in params.items():
        if PARAM_SPECS[key][:1] == ("model",) and mesh.shape["model"] > 1:
            row0, row1 = rows_of(mesh, key, value.shape[0])
            value = value[row0:row1].to(mesh.device, copy=True)  # only the cut reaches the device
        out[key] = value.to(mesh.device)
    return out


def _masked_rows(shard: torch.Tensor, idx: torch.Tensor, row0: int) -> torch.Tensor:
    """Rows ``idx`` (global ids) of ``shard``, which holds rows from ``row0``:
    the row where this rank holds it, 0 elsewhere."""
    li = idx.to(torch.int64) - row0
    owned = (li >= 0) & (li < shard.shape[0])
    if shard.shape[0] == 0:
        return shard.new_zeros((*idx.shape, *shard.shape[1:]))
    rows = shard[li.clamp(0, shard.shape[0] - 1)]
    return torch.where(owned.reshape(*owned.shape, *([1] * (shard.dim() - 1))), rows, 0.0)


def owned_rows(mesh: Mesh, shard: torch.Tensor, idx: torch.Tensor, row0: int) -> torch.Tensor:
    """Global rows ``idx`` (any shape) of a table whose rows ``[row0, row0 +
    len(shard))`` this rank holds: the owner adds each row, every other rank
    adds 0, and one ``all_reduce`` over ``model`` assembles them.  Exact:
    every row has one owner and x + 0 = x."""
    return mesh.all_reduce(_masked_rows(shard, idx, row0).contiguous(), "model")


def owned_tables(mesh: Mesh, tables: Dict[str, torch.Tensor], idx: torch.Tensor,
                 row0: int) -> Dict[str, torch.Tensor]:
    """:func:`owned_rows` of several tables cut alike (the same rows held)
    in one ``all_reduce``: their rows side by side in one buffer."""
    parts = [_masked_rows(t, idx, row0).reshape(*idx.shape, -1) for t in tables.values()]
    both = mesh.all_reduce(torch.cat(parts, dim=-1), "model")
    out, col = {}, 0
    for (key, t), part in zip(tables.items(), parts):
        out[key] = both[..., col:col + part.shape[-1]].reshape(*idx.shape, *t.shape[1:])
        col += part.shape[-1]
    return out


def gather_params(mesh: Mesh, params: Dict[str, torch.Tensor], n_entities: int) -> Dict[str, torch.Tensor]:
    """The full tables on every rank: each cut table assembled from its
    owners (its rows at their place, zeros elsewhere, one ``all_reduce`` over
    ``model``); the replicated ones as they are.  R is the replicated
    ``relation`` table's row count."""
    out = dict(params)
    if mesh.shape["model"] > 1:
        n_relations = params["relation"].shape[0]
        for key, shard in params.items():
            if PARAM_SPECS[key][:1] != ("model",):
                continue
            n = n_entities if key == "entity" else n_relations
            row0, row1 = rows_of(mesh, key, n)
            full = shard.new_zeros((n, *shard.shape[1:]))
            full[row0:row1] = shard
            out[key] = mesh.all_reduce(full, "model")
    return out
