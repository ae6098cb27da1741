"""Unified evaluation entry point (counterpart of ``kb2e_tpu/cli/eval.py``).

Analogue of ``evalTransE`` (``transe/bin/evalTransE.cpp:9-18``): load trained
embeddings from ``--outdir``, rank every test triple's head and tail against
all entities, print raw + filtered MeanRank and Hits@10 in the reference's
exact format (``common/evaluation.cpp:247-250``).  ``--task relation`` ranks
each test triple's relation among all R instead and prints the two
``Relation Raw/Filtered`` lines.  Runs on ``--device`` (default ``cuda``).
The port evaluates TransE, TransH, TransR, CTransR and PTransE in both tasks.
PTransE's relation task adds path evidence: the PCRA store of the test pairs
over the train graph (``data/paths.py``).

Under ``torchrun`` with ``--data-axis`` × ``--model-axis`` above 1 the
entity task runs on the (data, model) mesh: the entity rows (and TransR's
and CTransR's per-relation tables) cut over ``model``, every rank printing
the one-rank lines.  Without ``torchrun`` those flags raise; the JAX eval CLI
ignores them.
"""

from __future__ import annotations

import os
import sys

import torch

from kb2e_tpu_torch import constants as C
from kb2e_tpu_torch.cli import common
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import paths as paths_lib
from kb2e_tpu_torch.data import triples as data_lib
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.io import text as text_io
from kb2e_tpu_torch.models import base as model_base
from kb2e_tpu_torch.parallel import mesh as mesh_lib
from kb2e_tpu_torch.parallel import multihost, sharding
from kb2e_tpu_torch.utils.device import resolve_device


def run_eval(model_name: str, cfg: EmbeddingConfig, verbose: bool = True, device="cuda", task: str = "entity") -> dict:
    """Evaluate the files of ``cfg.output_dir``; returns the metrics.

    With ``cfg.data_axis`` × ``cfg.model_axis`` > 1 this process is one rank
    of a ``torchrun`` launch (``mesh_lib.from_torchrun`` raises otherwise)
    and the entity task runs sharded over the mesh; every rank prints the
    metrics.  The relation task has no sharded path and raises then."""
    mesh, own_group = None, False
    if mesh_lib.axes_product(cfg.data_axis, cfg.model_axis) > 1:
        if task == "relation":
            raise NotImplementedError(harness.NO_SHARDED_RELATION_TASK)
        own_group = not torch.distributed.is_initialized()
        mesh = mesh_lib.from_torchrun(cfg.data_axis, cfg.model_axis, device)
        print(f"rank {multihost.process_index()} of {multihost.process_count()}: {mesh}")
    try:
        return _evaluate_files(model_name, cfg, verbose, device if mesh is None else mesh.device, task, mesh)
    finally:
        if own_group:
            # The process group this call made; the ranks leave it together.
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            torch.distributed.destroy_process_group()


def _evaluate_files(model_name: str, cfg: EmbeddingConfig, verbose: bool, device, task: str, mesh) -> dict:
    dev = resolve_device(device)
    model = model_base.get_model(model_name)
    print(cfg.describe())

    tag = C.Method.from_any(cfg.method).tag
    for basename in (C.RELATION_EMBEDDING_BASENAME, C.ENTITY_EMBEDDING_BASENAME):
        path = os.path.join(cfg.output_dir, f"{basename}.{tag}")
        if not os.path.exists(path):
            # Message parity with common/evaluation.cpp:253-262.
            print(
                f"Could not find {'relation' if 'relation' in basename else 'entity'} "
                f"embedding file: {path}. Make sure to specify the path and/or train.",
            )
            sys.exit(2)

    dataset = data_lib.load_dataset(cfg.data_dir, splits=("train", "valid", "test"))
    n_ent, n_rel, k = dataset.n_entities, dataset.n_relations, cfg.embedding_size
    host = text_io.read_embeddings(
        cfg.output_dir, C.Method.from_any(cfg.method), n_ent, n_rel, k, weights_shape=model.weights_shape(n_rel, k)
    )
    bad = text_io.entity_norm_warnings(host["entity"])
    if bad:
        # Analogue of the "wrong_entity" warning (common/evaluation.cpp:99-102).
        print(f"Warning: {bad} entity rows exceed unit norm by >1e-3", file=sys.stderr)

    arrays = {name: host[name] for name in ("entity", "relation")}
    if model.weights_key is not None:
        arrays[model.weights_key] = host["weights"]
    # CTransR's relation_clusters / cluster_centers, PTransE's relation_inv
    # (and comp_w for RNN), from the sidecar's extras.
    arrays.update({key: host[name] for name, key in model.file_extras.items() if name in host})
    params = params_from_numpy({name: a.astype("float32") for name, a in arrays.items()}, "cpu" if mesh is not None else dev)
    if mesh is not None:
        # Each rank's device holds only its cut of the cut tables.
        params = sharding.place_params(mesh, params)
    if task == "relation":
        path_store = None
        if model.uses_paths:
            train = dataset.train
            path_store = paths_lib.build_path_store(
                train.heads, train.tails, train.rels, train.n_relations,
                max_len=cfg.path_length, min_conf=cfg.path_min_conf,
                max_paths=cfg.max_paths, max_branch=cfg.path_max_branch,
                n_entities=dataset.n_entities, query_pairs=(dataset.test[0], dataset.test[1]),
            )
        metrics = harness.evaluate_relation_prediction(model, params, dataset, cfg, path_store=path_store,
                                                       verbose=verbose, device=dev)
        print(f"Relation Raw      -- Rank: {metrics['raw_mean_rank']:f}, Hits@1: {metrics['raw_hits1']:f}")
        print(f"Relation Filtered -- Rank: {metrics['filtered_mean_rank']:f}, Hits@1: {metrics['filtered_hits1']:f}")
        return metrics
    metrics = harness.evaluate(model, params, dataset, cfg, verbose=verbose, device=dev, mesh=mesh)
    harness.print_reference_style(metrics)
    harness.print_extended(metrics)
    return metrics


def main(argv=None, model_name=None):
    parser = common.build_parser("kb2e-eval", "Evaluate Trans* embeddings (link prediction)")
    if model_name is None:
        parser.add_argument("--model", default="transe", choices=common.MODELS)
    parser.add_argument("--task", default="entity", choices=("entity", "relation"),
                        help="link-prediction task: rank entities (reference) "
                             "or relations (PTransE paper task 2)")
    args = parser.parse_args(argv)
    cfg = common.config_from_args(args)
    return run_eval(model_name or args.model, cfg, device=args.device, task=args.task)


if __name__ == "__main__":
    main()
