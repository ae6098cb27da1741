"""Epoch loop.

Counterpart of ``kb2e_tpu/train/loop.py``.  Mirrors the observable behaviour
of ``Trainer::train`` / ``bfgs`` (``common/trainer.cpp:60-107``): init
params, run ``max_epochs`` epochs of ``num_batches`` batches of
``|T| // num_batches`` samples, print the per-epoch loss in the reference's
format.  Adds JSONL metrics (loss, wall time, triples/s), periodic
checkpoints with resume, and periodic link-prediction eval.

All randomness — the initial tables and every sampled batch — comes from one
``torch.Generator`` on the training device, seeded with
``cfg.resolved_seed()``.  A checkpoint stores that generator's state, and
resume restores it, where ``kb2e_tpu`` replays its key splits.  Given
``init_params`` (the TransE warm start of TransR, CTransR and PTransE) the loop starts from those
tables and its generator draws only the batches.

Given a mesh (``parallel/mesh.py``; ``kb2e_tpu/train/loop.py:99-118``), which
``cfg.data_axis`` × ``cfg.model_axis`` > 1 requires, every rank seeds the same generator, so all draw the same tables and
batches; the batch is rounded down to a multiple of the data axis, the
entity rows are cut over the model axis, and the fast epoch runs through
``parallel/dist_step.py``.  Parity mode runs on one device only.  Rank 0
writes the checkpoints, with the full tables; on resume every rank reads the
file and keeps its rows.  The returned params are the full tables on every
rank.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Optional

import torch

from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.data.triples import TripleSet
from kb2e_tpu_torch.io import checkpoint as ckpt_lib
from kb2e_tpu_torch.models.base import Model, Params
from kb2e_tpu_torch.parallel import mesh as mesh_lib
from kb2e_tpu_torch.parallel import multihost, sharding
from kb2e_tpu_torch.train import step as step_lib
from kb2e_tpu_torch.utils import logging as log_lib
from kb2e_tpu_torch.utils.device import resolve_device


def train(
    model: Model,
    cfg: EmbeddingConfig,
    triples: TripleSet,
    *,
    init_params: Optional[Params] = None,
    metrics_fn: Optional[Callable[[dict], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    eval_every: int = 0,
    eval_fn: Optional[Callable[[Params], dict]] = None,
    path_store=None,
    device="cuda",
    mesh: Optional[mesh_lib.Mesh] = None,
    after_epoch: Optional[Callable[[int], None]] = None,
) -> Params:
    """Train embeddings on ``device``; returns the final params.

    ``update_mode`` 'fast' runs one presampled epoch per epoch
    (:class:`step_lib.EpochRunner`); 'parity' samples each batch and applies
    it with ``model.sequential_update``.  ``init_params`` replaces the
    model's initial tables (they are moved to ``device``).  ``path_store``
    (PTransE's ``data/paths.py::PathStore`` of ``triples``) goes to the
    device with the triples, and every batch then carries its rows' paths.
    ``mesh`` runs the fast epochs over its ranks (on its device);
    ``after_epoch(n)`` is called once n epochs are done and checkpointed.
    """
    if mesh is None and mesh_lib.axes_product(cfg.data_axis, cfg.model_axis) > 1:
        raise ValueError(
            f"data axis {cfg.data_axis} x model axis {cfg.model_axis} needs a mesh, and none was passed: start one "
            "process per rank and pass mesh= (parallel/mesh.py::from_torchrun or make_mesh)")
    dev = resolve_device(device if mesh is None else mesh.device)
    if cfg.update_mode not in ("fast", "parity"):
        raise ValueError(f"update_mode={cfg.update_mode!r}; expected 'fast' or 'parity'")
    if mesh is not None and cfg.update_mode == "parity":
        raise NotImplementedError("parity mode runs single-device only")
    if cfg.update_mode == "parity" and not model.has_parity_mode:
        warnings.warn(
            f"--update-mode parity has no effect for {model.name}: no "
            "reference binary exists to be sequentially faithful to, so the "
            "vectorised update is the defining semantics.",
            stacklevel=2,
        )
    generator = torch.Generator(device=dev).manual_seed(cfg.resolved_seed())
    if init_params is None:
        params = model.init_params(generator, triples.n_entities, triples.n_relations, cfg, dev)
    else:
        params = {k: v.to(dev) for k, v in init_params.items()}

    start_epoch = 0
    if resume and checkpoint_dir:
        latest = ckpt_lib.latest_in(checkpoint_dir)
        if latest is not None:
            restored, start_epoch, meta = ckpt_lib.restore(latest)
            params = {k: v.to(dev) for k, v in restored.items()}
            generator.set_state(meta["generator_state"])
            print(f"Resumed from {latest} at epoch {start_epoch}")

    data = step_lib.DeviceData.from_triple_set(triples, dev, path_store=path_store)
    batch_size = step_lib.batch_size_for(triples.num_triples, cfg.num_batches)
    if mesh is not None:
        batch_size -= batch_size % mesh.shape["data"]
        params = sharding.place_params(mesh, params)

    def full(p: Params) -> Params:
        return p if mesh is None else sharding.gather_params(mesh, p, triples.n_entities)

    if cfg.update_mode == "fast":
        run_epoch = step_lib.make_epoch_runner(model, cfg, batch_size, cfg.num_batches, mesh=mesh)
    else:
        run_step = step_lib.make_train_step(model, cfg, batch_size)

    logger = log_lib.MetricsLogger(metrics_fn)
    total_samples = batch_size * cfg.num_batches
    for epoch in range(start_epoch, cfg.max_epochs):
        t0 = time.perf_counter()
        if cfg.update_mode == "fast":
            params, loss = run_epoch(params, generator, data)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(cfg.num_batches):
                params, batch_loss = run_step(params, generator, data)
                loss = loss + batch_loss
        loss_val = float(loss)  # waits for the epoch
        dt = time.perf_counter() - t0
        # Reference epoch line (common/trainer.cpp:105).
        print(f"Epoch: {epoch}, Loss: {loss_val:f}")
        logger.log(
            {
                "epoch": epoch,
                "loss": loss_val,
                "wall_s": dt,
                "triples_per_s": total_samples / dt if dt > 0 else 0.0,
                "batch_size": batch_size,
            }
        )
        if checkpoint_dir and checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            tables = full(params)
            if multihost.process_index() == 0:
                ckpt_lib.save(
                    os.path.join(checkpoint_dir, f"ckpt_{epoch + 1}"), tables, step=epoch + 1,
                    extra={"generator_state": generator.get_state()},
                )
            multihost.barrier()
        if after_epoch is not None:
            after_epoch(epoch + 1)
        if eval_fn is not None and eval_every and (epoch + 1) % eval_every == 0:
            val = eval_fn(params)
            print(
                f"[valid @ epoch {epoch}] filtered MR {val.get('filtered_mean_rank', float('nan')):.1f}, "
                f"filtered Hits@10 {val.get('filtered_hits10', float('nan')):.3f}"
            )
            logger.log({"epoch": epoch, **{f"valid_{k}": v for k, v in val.items()}})
    return full(params)
