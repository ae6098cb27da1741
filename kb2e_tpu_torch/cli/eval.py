"""Unified evaluation entry point (counterpart of ``kb2e_tpu/cli/eval.py``).

Analogue of ``evalTransE`` (``transe/bin/evalTransE.cpp:9-18``): load trained
embeddings from ``--outdir``, rank every test triple's head and tail against
all entities, print raw + filtered MeanRank and Hits@10 in the reference's
exact format (``common/evaluation.cpp:247-250``).  ``--task relation`` ranks
each test triple's relation among all R instead and prints the two
``Relation Raw/Filtered`` lines.  Runs on ``--device`` (default ``cuda``).
The port evaluates TransE, TransH, TransR and CTransR in both tasks; PTransE
raises until its slice lands.
"""

from __future__ import annotations

import os
import sys

from kb2e_tpu_torch import constants as C
from kb2e_tpu_torch.cli import common
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.convert import params_from_numpy
from kb2e_tpu_torch.data import triples as data_lib
from kb2e_tpu_torch.eval import harness
from kb2e_tpu_torch.io import text as text_io
from kb2e_tpu_torch.models import base as model_base
from kb2e_tpu_torch.utils.device import resolve_device


def run_eval(model_name: str, cfg: EmbeddingConfig, verbose: bool = True, device="cuda", task: str = "entity") -> dict:
    common.check_ported(model_name)
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
    # CTransR's relation_clusters / cluster_centers, from the sidecar's extras.
    arrays.update({key: host[name] for name, key in model.file_extras.items()})
    params = params_from_numpy({name: a.astype("float32") for name, a in arrays.items()}, dev)
    if task == "relation":
        metrics = harness.evaluate_relation_prediction(model, params, dataset, cfg, verbose=verbose, device=dev)
        print(f"Relation Raw      -- Rank: {metrics['raw_mean_rank']:f}, Hits@1: {metrics['raw_hits1']:f}")
        print(f"Relation Filtered -- Rank: {metrics['filtered_mean_rank']:f}, Hits@1: {metrics['filtered_hits1']:f}")
        return metrics
    metrics = harness.evaluate(model, params, dataset, cfg, verbose=verbose, device=dev)
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
