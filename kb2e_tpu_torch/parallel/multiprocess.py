"""Multi-process training driver (counterpart of ``kb2e_tpu/parallel/multiprocess.py``).

One process per rank, each started with the same ``--coordinator host:port``
and ``--num-processes`` and its own ``--process-id``:

1. every rank joins the process group (``multihost.initialize``: NCCL on a
   CUDA ``--device``, gloo on the CPU, with a timeout);
2. each rank keeps only its contiguous shard of the train split
   (``partition_edges``) and the bern statistics are merged exactly across
   ranks (``global_bern_stats``);
3. the edge list is gathered whole on every rank (``allgather_edges``) for
   the replicated sampler;
4. the (data, model) mesh is built, every rank draws the same initial tables
   and keeps its entity rows, and ``train/loop.py`` runs the fast epochs
   through ``parallel/dist_step.py``;
5. rank 0 writes a checkpoint file every ``--checkpoint-every`` epochs with
   the full tables and the generator's state; with ``--resume`` every rank
   reads the newest and keeps its rows, and the run continues as the
   uninterrupted one would.

``--die-after-epoch`` / ``--die-process-id`` make one rank exit hard
(``os._exit(17)``) after that epoch's checkpoint, to test recovery.
``--out-npz``: rank 0 writes the final full tables; ``--eval-out``: the
entity-sharded eval runs over the same mesh and rank 0 writes its metrics
as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from kb2e_tpu_torch.config import EmbeddingConfig


@dataclasses.dataclass
class MultihostRunConfig:
    coordinator: str  # "host:port"
    num_processes: int
    process_id: int
    data_axis: Optional[int] = None  # default: every rank
    model_axis: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    # Fault injection: this rank exits hard after the checkpoint of this
    # 1-based epoch.
    die_after_epoch: int = 0
    die_process_id: int = 0
    eval_out: Optional[str] = None
    device: str = "cuda"  # NCCL; "cpu": gloo


def run(model_name: str, cfg: EmbeddingConfig, mh: MultihostRunConfig, data_dir: str, *,
        out_npz: Optional[str] = None, verbose: bool = True):
    """Train ``model_name`` over the ranks; returns the final full tables."""
    import torch

    from kb2e_tpu_torch.data import triples as triples_lib
    from kb2e_tpu_torch.models import get_model
    from kb2e_tpu_torch.parallel import mesh as mesh_lib
    from kb2e_tpu_torch.parallel import multihost
    from kb2e_tpu_torch.train import loop as train_loop
    from kb2e_tpu_torch.utils.device import resolve_device

    dev = resolve_device(mh.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", mh.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    multihost.initialize(mh.coordinator, mh.num_processes, mh.process_id, device=dev)
    pid, n_proc = multihost.process_index(), multihost.process_count()

    def log(msg: str) -> None:
        if verbose:
            print(f"[p{pid}] {msg}", flush=True)

    log(f"{n_proc} processes, backend {torch.distributed.get_backend()}, device {dev}")
    full = triples_lib.load_dataset(data_dir, splits=("train",)).train
    lh, lt, lr, valid = multihost.partition_edges(full.heads, full.tails, full.rels, pid, n_proc)
    bern = multihost.global_bern_stats(lh, lt, lr, full.n_relations, valid=valid)
    gh, gt, gr = multihost.allgather_edges(lh, lt, lr, valid=valid)
    ts = triples_lib.TripleSet.from_arrays(gh, gt, gr, n_entities=full.n_entities, n_relations=full.n_relations)
    if not np.array_equal(bern, ts.bern_pr_tail):
        raise RuntimeError("the merged bern statistics differ from the whole list's (max abs diff "
                           f"{np.max(np.abs(bern - ts.bern_pr_tail)):.3e}): multihost.global_bern_stats is broken")
    log(f"edges: local {int(valid.sum())}/{lh.shape[0]} global {ts.num_triples}")

    data_axis = mh.data_axis or n_proc // mh.model_axis
    mesh = mesh_lib.make_mesh(data_axis, mh.model_axis, device=dev)
    log(f"mesh {mesh}")
    model = get_model(model_name)

    def after_epoch(done: int) -> None:
        if mh.die_after_epoch and done == mh.die_after_epoch and pid == mh.die_process_id:
            log(f"FAULT INJECTION: process {pid} dying after epoch {done}")
            os._exit(17)

    params = train_loop.train(model, cfg, ts, checkpoint_dir=mh.checkpoint_dir,
                              checkpoint_every=mh.checkpoint_every, resume=mh.resume, device=dev, mesh=mesh,
                              after_epoch=after_epoch)
    if out_npz:
        if pid == 0:
            np.savez(out_npz, **fetch_replicated(params))
            log(f"wrote {out_npz}")
        multihost.barrier()
    if mh.eval_out:
        from kb2e_tpu_torch.eval import harness

        ds = triples_lib.load_dataset(data_dir, splits=("train", "valid", "test"))
        metrics = harness.evaluate(model, params, ds, cfg, mesh=mesh)
        log(f"eval: filtered MR {metrics['filtered_mean_rank']:.4f} Hits@10 {metrics['filtered_hits10']:.4f}")
        if pid == 0:
            with open(mh.eval_out, "w", encoding="utf-8") as f:
                json.dump(metrics, f)
            log(f"wrote {mh.eval_out}")
        multihost.barrier()
    return params


def fetch_replicated(params) -> dict:
    """The full tables as host numpy (``train/loop.py`` returns them whole)."""
    return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


def main(argv: Optional[list] = None) -> None:
    """One rank of a multi-process training job: the trainer's flags, the
    rendezvous triple and the port's ``--device``."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--model", default="transe")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--size", type=int, default=100)
    ap.add_argument("--rate", type=float, default=0.001)
    ap.add_argument("--margin", type=float, default=1.0)
    ap.add_argument("--method", type=int, default=1)
    ap.add_argument("--batches", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--distance", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--data-axis", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out-npz", default=None)
    ap.add_argument("--eval-out", default=None)
    ap.add_argument("--die-after-epoch", type=int, default=0)
    ap.add_argument("--die-process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo) [cuda]")
    args = ap.parse_args(argv)

    cfg = EmbeddingConfig(
        embedding_size=args.size,
        learning_rate=args.rate,
        margin=args.margin,
        method=args.method,
        num_batches=args.batches,
        max_epochs=args.epochs,
        distance=args.distance,
        seed=args.seed,
    )
    mh = MultihostRunConfig(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        data_axis=args.data_axis,
        model_axis=args.model_axis,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        die_after_epoch=args.die_after_epoch,
        die_process_id=args.die_process_id,
        eval_out=args.eval_out,
        device=args.device,
    )
    try:
        run(args.model, cfg, mh, args.datadir, out_npz=args.out_npz)
    finally:
        import torch

        if torch.distributed.is_initialized():
            if torch.device(args.device).type == "cuda":
                torch.cuda.synchronize()  # no collective left in flight
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
