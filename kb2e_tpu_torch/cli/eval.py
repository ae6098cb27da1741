"""Unified evaluation entry point (counterpart of ``kb2e_tpu/cli/eval.py``).

Analogue of ``evalTransE`` (``transe/bin/evalTransE.cpp:9-18``): load trained
embeddings from ``--outdir``, rank every test triple's head and tail against
all entities, print raw + filtered MeanRank and Hits@10 in the reference's
exact format (``common/evaluation.cpp:247-250``).  Runs on ``--device``
(default ``cuda``).  The port carries the entity task for TransE and TransH;
the relation task and the other models come with later slices.
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

MODELS = ("transe", "transh")


def run_eval(model_name: str, cfg: EmbeddingConfig, verbose: bool = True, device="cuda") -> dict:
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
    # TransH reads its hyperplane normals from weights.<tag>, one row per relation.
    weights_shape = (n_rel, k) if model_name == "transh" else None
    host = text_io.read_embeddings(
        cfg.output_dir, C.Method.from_any(cfg.method), n_ent, n_rel, k, weights_shape=weights_shape
    )
    bad = text_io.entity_norm_warnings(host["entity"])
    if bad:
        # Analogue of the "wrong_entity" warning (common/evaluation.cpp:99-102).
        print(f"Warning: {bad} entity rows exceed unit norm by >1e-3", file=sys.stderr)

    arrays = {name: host[name] for name in ("entity", "relation")}
    if weights_shape is not None:
        arrays["norm"] = host["weights"]
    params = params_from_numpy({name: a.astype("float32") for name, a in arrays.items()}, dev)
    metrics = harness.evaluate(model, params, dataset, cfg, verbose=verbose, device=dev)
    harness.print_reference_style(metrics)
    harness.print_extended(metrics)
    return metrics


def main(argv=None, model_name=None):
    parser = common.build_parser("kb2e-eval", "Evaluate Trans* embeddings (link prediction)")
    if model_name is None:
        parser.add_argument("--model", default="transe", choices=MODELS)
    parser.add_argument("--task", default="entity", choices=("entity",),
                        help="link-prediction task: rank entities (reference)")
    args = parser.parse_args(argv)
    cfg = common.config_from_args(args)
    return run_eval(model_name or args.model, cfg, device=args.device)


if __name__ == "__main__":
    main()
