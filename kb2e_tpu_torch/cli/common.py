"""CLI argument surface, flag-compatible with the reference binaries and ``kb2e_tpu``.

Flag names, value conventions, and defaults mirror ``parseArgs``
(``common/args.cpp:53-122``): ``--datadir --outdir --size --rate --margin
--method --batches --epochs --distance --seeddatadir --seedmethod --seed``,
each also as ``-flag``, plus every extension flag of
``kb2e_tpu/cli/common.py``, so a command line written for one package
parses in the other.  The port adds ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse

from kb2e_tpu_torch import constants as C
from kb2e_tpu_torch.config import EmbeddingConfig
from kb2e_tpu_torch.utils.device import DEFAULT_DEVICE


MODELS = ("transe", "transh", "transr", "ctransr", "ptranse")
# Where each model not ported yet stands in ROADMAP.md's Queue 1.
NOT_PORTED = {"ptranse": "Queue 1 item 5 (PTransE)"}


def check_ported(model_name: str) -> None:
    """Raise ``NotImplementedError`` for a model the port does not run yet."""
    if model_name in NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported to kb2e_tpu_torch yet: ROADMAP.md {NOT_PORTED[model_name]}"
        )


def build_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)

    def add(name, **kw):
        p.add_argument(f"--{name}", f"-{name}", **kw)

    add("datadir", dest="data_dir", default=C.DEFAULT_DATA_DIR,
        help=f"data directory [{C.DEFAULT_DATA_DIR}]")
    add("outdir", dest="output_dir", default=C.DEFAULT_OUTPUT_DIR,
        help=f"output directory [{C.DEFAULT_OUTPUT_DIR}]")
    add("size", dest="embedding_size", type=int, default=C.DEFAULT_EMBEDDING_SIZE,
        help=f"embedding size [{C.DEFAULT_EMBEDDING_SIZE}]")
    add("rate", dest="learning_rate", type=float, default=C.DEFAULT_LEARNING_RATE,
        help=f"learning rate [{C.DEFAULT_LEARNING_RATE}]")
    add("margin", dest="margin", type=float, default=C.DEFAULT_MARGIN,
        help=f"margin [{C.DEFAULT_MARGIN}]")
    add("method", dest="method", default=str(int(C.DEFAULT_METHOD)),
        help="0/unif or 1/bern [1]")
    add("batches", dest="num_batches", type=int, default=C.DEFAULT_NUM_BATCHES,
        help=f"number of batches per epoch [{C.DEFAULT_NUM_BATCHES}]")
    add("epochs", dest="max_epochs", type=int, default=C.DEFAULT_MAX_EPOCHS,
        help=f"epochs [{C.DEFAULT_MAX_EPOCHS}]")
    add("distance", dest="distance", default=str(int(C.DEFAULT_DISTANCE)),
        help="0=L1, 1=L2 [0]")
    add("seeddatadir", dest="seed_data_dir", default=C.DEFAULT_SEED_DATA_DIR,
        help="TransR/CTransR warm-start directory [.]")
    add("seedmethod", dest="seed_method", default=str(int(C.DEFAULT_SEED_METHOD)),
        help="warm-start files' method tag [0 (unif)]")
    add("seed", dest="seed", type=int, default=None, help="PRNG seed [now]")

    add("device", dest="device", default=DEFAULT_DEVICE,
        help=f"torch device to run on; 'cpu' runs the kernels' plain versions [{DEFAULT_DEVICE}]")

    # Extensions shared with kb2e_tpu.
    add("update-mode", dest="update_mode", default="fast", choices=("fast", "parity"),
        help="fast = vectorised batch update; parity = reference-exact scan")
    add("negatives", dest="num_negatives", type=int, default=1,
        help="negatives per positive (1 = reference policy) [1]")
    add("dtype", dest="param_dtype", default="float32",
        choices=("float32", "bfloat16"),
        help="embedding-table storage dtype (TransE/PTransE) [float32]")
    add("eval-batch", dest="eval_batch_size", type=int, default=256)
    add("eval-block", dest="eval_block_size", type=int, default=4096)
    add("eval-impl", dest="eval_impl", default="auto", choices=("auto", "xla", "pallas"),
        help="ranking sweep [auto: the rank-count kernel; 'xla' has no counterpart here]")
    add("data-axis", dest="data_axis", type=int, default=None,
        help="mesh data-parallel axis size (default: single device)")
    add("model-axis", dest="model_axis", type=int, default=None,
        help="mesh model-parallel axis size (entity-table sharding)")
    add("metrics-jsonl", dest="metrics_jsonl", default=None,
        help="append per-epoch JSONL metrics to this path")
    add("tensorboard-dir", dest="tensorboard_dir", default=None,
        help="also stream per-epoch scalar metrics to a TensorBoard log dir")
    add("checkpoint-dir", dest="checkpoint_dir", default=None,
        help="directory for periodic checkpoints")
    add("checkpoint-every", dest="checkpoint_every", type=int, default=0,
        help="checkpoint every N epochs (0 = never)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    add("eval-every", dest="eval_every", type=int, default=0,
        help="evaluate link prediction on the valid split every N epochs")
    add("profile-dir", dest="profile_dir", default=None,
        help="capture a device trace of the run to this directory")

    # PTransE path-modelling flags.
    add("path-comp", dest="path_composition", default="add",
        choices=("add", "mul", "rnn"), help="relation-path composition [add]")
    add("path-weight", dest="path_weight", type=float, default=1.0,
        help="weight of the path loss term [1.0]")
    add("path-margin", dest="path_margin", type=float, default=1.0,
        help="margin of the relation-corruption path loss [1.0]")
    add("max-paths", dest="max_paths", type=int, default=8,
        help="paths kept per (h, t) pair [8]")
    add("path-length", dest="path_length", type=int, default=2,
        help="maximum path length in hops (2-step / 3-step) [2]")
    add("path-min-conf", dest="path_min_conf", type=float, default=0.01,
        help="minimum normalised PCRA reliability [0.01]")
    add("path-max-branch", dest="path_max_branch", type=int, default=0,
        help="skip (node, relation) fan-outs above this during extraction [0 = off]")
    return p


def config_from_args(args: argparse.Namespace) -> EmbeddingConfig:
    return EmbeddingConfig(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        embedding_size=args.embedding_size,
        learning_rate=args.learning_rate,
        margin=args.margin,
        method=C.Method.from_any(args.method),
        num_batches=args.num_batches,
        max_epochs=args.max_epochs,
        distance=C.Distance.from_any(args.distance),
        seed_data_dir=args.seed_data_dir,
        seed_method=C.Method.from_any(args.seed_method),
        seed=args.seed,
        update_mode=args.update_mode,
        num_negatives=args.num_negatives,
        param_dtype=args.param_dtype,
        eval_batch_size=args.eval_batch_size,
        eval_block_size=args.eval_block_size,
        eval_impl=args.eval_impl,
        data_axis=args.data_axis,
        model_axis=args.model_axis,
        path_composition=args.path_composition,
        path_weight=args.path_weight,
        path_margin=args.path_margin,
        max_paths=args.max_paths,
        path_length=args.path_length,
        path_min_conf=args.path_min_conf,
        path_max_branch=args.path_max_branch,
    )
