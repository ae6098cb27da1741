"""Unified training entry point (counterpart of ``kb2e_tpu/cli/train.py``).

``python -m kb2e_tpu_torch.cli.train --model transe --datadir ... --outdir ...``
is the analogue of the reference's ``trainTransE`` main
(``transe/bin/trainTransE.cpp:9-20``): parse args, echo options, train,
write reference-format embedding files.  Runs on ``--device`` (default
``cuda``).  ``--model`` keeps the JAX package's choices; the port trains
TransE and TransH, and the other models raise until their slices land.
"""

from __future__ import annotations

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

MODELS = ("transe", "transh", "transr", "ctransr", "ptranse")
# Where each model not ported yet stands in ROADMAP.md's Queue 1.
NOT_PORTED = {
    "transr": "Queue 1 item 9 (TransR, kernel K5; its TransE warm start with it)",
    "ctransr": "Queue 1 item 10 (CTransR)",
    "ptranse": "Queue 1 item 11 (PTransE)",
}


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
    if model_name in NOT_PORTED:
        raise NotImplementedError(f"{model_name} is not ported to kb2e_tpu_torch yet: ROADMAP.md {NOT_PORTED[model_name]}")
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

    logger = log_lib.jsonl_logger(metrics_jsonl) if metrics_jsonl else None
    tb_sink = log_lib.TensorBoardSink(tensorboard_dir) if tensorboard_dir else None
    metrics_fn = log_lib.fan_out(logger.log if logger else None, tb_sink)
    try:
        params = train_loop.train(
            model,
            cfg,
            ts,
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
    # TransH's hyperplane normals go to weights.<tag>, one row per relation.
    text_io.write_embeddings(
        cfg.output_dir, C.Method.from_any(cfg.method), host["entity"], host["relation"],
        weights=host.get("norm"), model_name=model_name,
    )
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
        parser.add_argument("--model", default="transe", choices=MODELS)
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
