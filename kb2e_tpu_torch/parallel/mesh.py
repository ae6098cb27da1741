"""The (data, model) grid of ranks (counterpart of ``kb2e_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices and lets GSPMD
place the collectives.  Here one process is one rank (``torchrun`` or
``parallel/multiprocess.py`` starts them), and a :class:`Mesh` is the ranks
laid out row-major on a (data, model) grid with two families of process
groups:

* ``data``  — the ranks of one column (same model index): each scores its
  contiguous share of every batch, and their row deltas are summed
  (``parallel/dist_step.py``);
* ``model`` — the ranks of one row (same data index): the entity table's rows
  are cut among them (:meth:`Mesh.entity_rows`), and so are TransR's and
  CTransR's per-relation tables on the relation axis
  (:meth:`Mesh.relation_rows`); a row or an energy reaches the others from
  its owner by one ``all_reduce`` (the owner adds the value, every other rank
  adds 0).

Only ``all_reduce`` and ``broadcast`` run on the device, so the same code runs
over NCCL and over gloo, whose collectives take CUDA tensors too.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Rank r's entity rows start at a multiple of this many rows: a shard's
# columns of the whole table's aligned transpose
# (``ops/rank_count.py::aligned_transpose``) then start 16-byte aligned, as
# the rank count's ``cp.async`` copies read them in place.
ROW_ALIGN = 4


def shard_bounds(n: int, parts: int) -> Tuple[int, ...]:
    """Cut points of ``n`` rows into ``parts`` contiguous shards: the same
    size, rounded up to ``ROW_ALIGN`` rows, except the last (which may be
    short, or empty when ``n`` is small)."""
    per = -(-n // parts)
    per = -(-per // ROW_ALIGN) * ROW_ALIGN
    return tuple(min(i * per, n) for i in range(parts + 1))


class Mesh:
    """This rank's place on the (data, model) grid, its two process groups
    and its device.  ``shape`` is ``{"data": d, "model": m}``; ``coords`` is
    (data index, model index).  Without a process group (one rank, no
    ``torch.distributed``) both groups are None and every collective is the
    identity."""

    def __init__(self, shape: Dict[str, int], coords: Tuple[int, int], groups: Dict[str, Optional[object]],
                 device: torch.device):
        self.shape, self.coords, self.groups, self.device = shape, coords, groups, device

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    def entity_rows(self, n: int) -> Tuple[int, int]:
        """[row0, row1): the entity rows this rank holds out of ``n``."""
        cuts = shard_bounds(n, self.shape["model"])
        return cuts[self.model_index], cuts[self.model_index + 1]

    def relation_rows(self, r: int) -> Tuple[int, int]:
        """[rel0, rel1): the relations this rank holds out of ``r`` in the
        tables cut on the relation axis: contiguous cuts of ceil(r / model)
        relations, the last shorter (or empty).  No alignment: no kernel reads
        these tables in place.  The JAX package pads R to a multiple of the
        axis and cuts it evenly instead; every relation has one owner either
        way."""
        m = self.shape["model"]
        per = -(-r // m)
        return min(self.model_index * per, r), min((self.model_index + 1) * per, r)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``x`` in place over the ranks of ``axis`` ('data' or 'model'); returns it."""
        group = self.groups[axis]
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, coords={self.coords}, {self.device})"


def _axis_sizes(data: Optional[int], model: Optional[int], n: int) -> Tuple[int, int]:
    """The JAX package's defaults: every rank on ``data``; one axis given, the
    other takes the rest."""
    if data is None and model is None:
        return n, 1
    if data is None:
        return n // model, model
    if model is None:
        return data, n // data
    return data, model


def make_mesh(data: Optional[int] = None, model: Optional[int] = None, ranks: Optional[Sequence[int]] = None,
              device=None) -> Optional[Mesh]:
    """A (data, model) mesh over ``ranks`` (default: every rank of the process
    group), row-major as ``kb2e_tpu``'s ``reshape(data, model)``.

    Every rank of the process group must call this (the groups are made
    collectively); a rank outside ``ranks`` gets None.  Raises ValueError when
    data × model is not the number of ranks.  ``device`` defaults to the
    current CUDA device under NCCL and to the CPU under gloo.  Without a
    process group only the 1 × 1 mesh exists.
    """
    if not dist.is_initialized():
        d, m = _axis_sizes(data, model, 1)
        if d * m != 1:
            raise ValueError(
                f"mesh {d}x{m} needs {d * m} ranks, and there is no process group: start one process per rank "
                f"(torchrun --nproc_per_node {d * m} -m kb2e_tpu_torch.cli.train_<model> ..., or "
                "python -m kb2e_tpu_torch.parallel.multiprocess)")
        return Mesh({"data": 1, "model": 1}, (0, 0), {"data": None, "model": None},
                    torch.device(device if device is not None else "cpu"))
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    d, m = _axis_sizes(data, model, len(ranks))
    if d < 1 or m < 1 or d * m != len(ranks):
        raise ValueError(f"mesh {d}x{m} != {len(ranks)} ranks (world size {dist.get_world_size()}); "
                         "start data x model processes (torchrun --nproc_per_node)")
    grid = [ranks[i * m:(i + 1) * m] for i in range(d)]
    me = dist.get_rank()
    groups: Dict[str, Optional[object]] = {}
    # Rows (model groups), then columns (data groups): the same order on every rank.
    for axis, members in (("model", grid), ("data", [list(col) for col in zip(*grid)])):
        for ids in members:
            group = dist.new_group(ids)
            if me in ids:
                groups[axis] = group
    if me not in ranks:
        return None
    pos = ranks.index(me)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    return Mesh({"data": d, "model": m}, (pos // m, pos % m), groups, torch.device(device))


def single_device_mesh(device=None) -> Mesh:
    """The 1 × 1 mesh of this process alone, with no collectives."""
    return Mesh({"data": 1, "model": 1}, (0, 0), {"data": None, "model": None},
                torch.device(device if device is not None else "cpu"))


def axes_product(data_axis: Optional[int], model_axis: Optional[int]) -> int:
    """data × model as the flags give them (None counts as 1)."""
    return (data_axis or 1) * (model_axis or 1)


def from_torchrun(data_axis: Optional[int], model_axis: Optional[int], device="cuda") -> Mesh:
    """The process group of a ``torchrun`` launch and its mesh, for the
    CLIs' ``--data-axis`` / ``--model-axis``.

    Raises before any rendezvous when the process was not started by
    ``torchrun`` (no ``WORLD_SIZE`` in the environment), when the world size
    is not data × model, or when NCCL would put two ranks on one card.  Each
    rank's device is ``cuda:{LOCAL_RANK % device_count}``; the backend is
    NCCL on CUDA and gloo on the CPU.
    """
    from kb2e_tpu_torch.parallel import multihost

    want = axes_product(data_axis, model_axis)
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"--data-axis {data_axis} --model-axis {model_axis} asks for {want} ranks, but this process was not "
            f"started by torchrun: run torchrun --nproc_per_node {want} -m kb2e_tpu_torch.cli.train_<model> "
            "(or eval_<model>) ...")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    d, m = _axis_sizes(data_axis, model_axis, world)
    if d * m != world:
        raise ValueError(f"--data-axis {data_axis} --model-axis {model_axis} makes a {d}x{m} mesh, but torchrun "
                         f"started {world} ranks: run torchrun --nproc_per_node {d * m}")
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        n_dev = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if n_dev == 0:
            raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
        if local_world > n_dev:
            raise RuntimeError(f"{local_world} ranks on this host but {n_dev} CUDA card(s): NCCL takes one rank per "
                               "card (two ranks on one card run only over gloo, "
                               "kb2e_tpu_torch.parallel.multihost.initialize(backend='gloo'))")
        dev = torch.device("cuda", local % n_dev)
        torch.cuda.set_device(dev)
    multihost.initialize("env://", world, rank, device=dev)
    return make_mesh(d, m, device=dev)
