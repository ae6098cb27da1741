"""Unified training entry point (counterpart of ``kb2e_tpu/cli/train.py``).

``python -m kb2e_tpu_torch.cli.train --model transe --datadir ... --outdir ...``
is the analogue of the reference's ``trainTransE`` main
(``transe/bin/trainTransE.cpp:9-20``): parse args, echo options, train,
write reference-format embedding files.  Runs on ``--device`` (default
``cuda``).  ``--model`` keeps the JAX package's choices; the port trains
TransE, TransH, TransR and CTransR, and PTransE raises until its slice lands.
"""

from __future__ import annotations

import os
import sys

import torch

from kb2e_tpu_torch import constants as C
from kb2e_tpu_torch.cli import common
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.convert import params_to_numpy
from kb2e_tpu_torch.data import triples as data_lib
from kb2e_tpu_torch.io import text as text_io
from kb2e_tpu_torch.models import base as model_base
from kb2e_tpu_torch.train import loop as train_loop
from kb2e_tpu_torch.utils import logging as log_lib
from kb2e_tpu_torch.utils import profiling
from kb2e_tpu_torch.utils.device import resolve_device


def run_training(
    model_name: str,
    cfg: EmbeddingConfig,
    metrics_jsonl=None,
    tensorboard_dir=None,
    checkpoint_dir=None,
    checkpoint_every=0,
    resume=False,
    eval_every=0,
    device="cuda",
):
    """Train ``model_name`` and write its embedding files; returns the params."""
    common.check_ported(model_name)
    dev = resolve_device(device)
    model = model_base.get_model(model_name)
    print(cfg.describe())

    # Load the valid split too when periodic evaluation is requested.
    splits = ("train", "valid", "test") if eval_every else ("train",)
    dataset = data_lib.load_dataset(cfg.data_dir, splits=splits)
    ts = dataset.train
    # Dataset count echo (common/trainer.cpp:199-200).
    print(f"Number of Relations: {ts.n_relations}")
    print(f"Number of Entities: {ts.n_entities}")

    init_params = _maybe_warm_start(model, cfg, ts, dev) if model.has_warm_start else None

    logger = log_lib.jsonl_logger(metrics_jsonl) if metrics_jsonl else None
    tb_sink = log_lib.TensorBoardSink(tensorboard_dir) if tensorboard_dir else None
    metrics_fn = log_lib.fan_out(logger.log if logger else None, tb_sink)
    try:
        params = train_loop.train(
            model,
            cfg,
            ts,
            init_params=init_params,
            metrics_fn=metrics_fn,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            resume=resume,
            eval_every=eval_every,
            eval_fn=_make_valid_eval(model, cfg, dataset, dev) if eval_every else None,
            device=dev,
        )
    finally:
        if tb_sink is not None:
            tb_sink.close()
        if logger is not None:
            logger.close()

    host = params_to_numpy({k: v.float() for k, v in params.items()})
    text_io.write_embeddings(
        cfg.output_dir, C.Method.from_any(cfg.method), host["entity"], host["relation"],
        weights=host[model.weights_key] if model.weights_key else None, model_name=model_name,
        extras={name: host[key] for name, key in model.file_extras.items()} or None,
    )
    return params


def _maybe_warm_start(model, cfg: EmbeddingConfig, ts, device):
    """The TransE warm start (TransR's, transr/trainer.cpp:88-113), as
    ``kb2e_tpu/cli/train.py::_maybe_warm_start``.

    The initial tables come from a generator seeded with
    ``seed ^ 0x5EED`` (the JAX package's warm-start key), then the entities
    and relations are replaced by ``entity2vec.<tag>`` / ``relation2vec.<tag>``
    of ``--seeddatadir`` (``--seedmethod``'s tag).  CTransR then takes its
    cluster centers from ``build_centers`` on the warm-started entities,
    seeded with ``cfg.resolved_seed()``; its ``relation_c`` keeps the init
    broadcast, as in the JAX package.  The reference fails when the seed
    files are missing; here the model starts from those random tables (for
    CTransR with zero centers) with a warning.
    """
    tag = C.Method.from_any(cfg.seed_method).tag
    ent_path = os.path.join(cfg.seed_data_dir, f"{C.ENTITY_EMBEDDING_BASENAME}.{tag}")
    rel_path = os.path.join(cfg.seed_data_dir, f"{C.RELATION_EMBEDDING_BASENAME}.{tag}")
    generator = torch.Generator(device=device).manual_seed(cfg.resolved_seed() ^ 0x5EED)
    params = model.init_params(generator, ts.n_entities, ts.n_relations, cfg, device)
    if not (os.path.exists(ent_path) and os.path.exists(rel_path)):
        print(
            f"Warning: seed files not found under '{cfg.seed_data_dir}' — "
            f"starting {model.name} from random init instead of a TransE warm start.",
            file=sys.stderr,
        )
        return params
    ent = text_io.read_matrix(ent_path, ts.n_entities, cfg.embedding_size)
    rel = text_io.read_matrix(rel_path, ts.n_relations, cfg.embedding_size)
    params = model.warm_start_params(params, ent, rel)
    if model.cluster_aware:
        from kb2e_tpu_torch.models import ctransr

        centers = ctransr.build_centers(params["entity"].cpu().numpy(), ts.heads, ts.tails, ts.rels, ts.n_relations,
                                        model.n_clusters, seed=cfg.resolved_seed())
        params = model.with_centers(params, centers)
    return params


def _make_valid_eval(model, cfg: EmbeddingConfig, dataset, device):
    """Periodic link-prediction eval on the VALID split (no reference counterpart)."""
    from kb2e_tpu_torch.eval import harness

    if dataset.valid is None or dataset.valid[0].size == 0:
        return None

    def eval_fn(params):
        return harness.evaluate(model, params, dataset, cfg, test_triples=dataset.valid, device=device)

    return eval_fn


def main(argv=None, model_name=None):
    parser = common.build_parser("kb2e-train", "Train Trans* knowledge-graph embeddings")
    if model_name is None:
        parser.add_argument("--model", default="transe", choices=common.MODELS)
    args = parser.parse_args(argv)
    cfg = common.config_from_args(args)
    with profiling.capture_trace(args.profile_dir):
        return run_training(
            model_name or args.model,
            cfg,
            metrics_jsonl=args.metrics_jsonl,
            tensorboard_dir=args.tensorboard_dir,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            eval_every=args.eval_every,
            device=args.device,
        )


if __name__ == "__main__":
    main()
