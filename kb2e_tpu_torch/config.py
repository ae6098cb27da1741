"""Run configuration.

``EmbeddingConfig`` mirrors the reference's 12-field ``EmbeddingArguments``
(``common/args.h:9-28``, defaults at ``common/args.cpp:19-31``) and carries
every extension field of ``kb2e_tpu.config.EmbeddingConfig`` with the same
name and default, so the two packages parse the same flags.  Fields whose
code path is not ported yet (training, mesh, PTransE) are carried unread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from kb2e_tpu_torch import constants as C


@dataclasses.dataclass
class EmbeddingConfig:
    # --- reference-parity fields (common/args.h:9-25) ---
    data_dir: str = C.DEFAULT_DATA_DIR
    output_dir: str = C.DEFAULT_OUTPUT_DIR
    embedding_size: int = C.DEFAULT_EMBEDDING_SIZE
    learning_rate: float = C.DEFAULT_LEARNING_RATE
    margin: float = C.DEFAULT_MARGIN
    method: C.Method = C.DEFAULT_METHOD
    num_batches: int = C.DEFAULT_NUM_BATCHES
    max_epochs: int = C.DEFAULT_MAX_EPOCHS
    distance: C.Distance = C.DEFAULT_DISTANCE
    seed_data_dir: str = C.DEFAULT_SEED_DATA_DIR
    seed_method: C.Method = C.DEFAULT_SEED_METHOD
    # Reference defaults the seed to time(NULL) (common/args.cpp:30) — runs are
    # only reproducible when --seed is given; we keep that behaviour.
    seed: Optional[int] = None

    # --- extensions (no reference counterpart) ---
    # Corruption candidates drawn per sample (training sampler).
    corruption_resample_rounds: int = 4
    # Negatives drawn per positive (training sampler).
    num_negatives: int = 1
    # Embedding-table storage dtype: 'float32' or 'bfloat16'.  Evaluation
    # always scores in float32.
    param_dtype: str = "float32"
    # Entity-axis block size of the plain (CPU) ranking sweep.  The CUDA
    # rank-count kernel tiles the entity axis itself and ignores it.
    eval_block_size: int = 4096
    # Evaluation query batch (number of (triple, direction) queries scored
    # together against all entities).
    eval_batch_size: int = 256
    # Ranking sweep implementation.  The port has one sweep, the hand-written
    # rank-count kernel (its plain version on CPU tensors): 'auto' and
    # 'pallas' both select it; 'xla' is refused by the harness.
    eval_impl: str = "auto"
    # 'fast' = vectorised batch update; 'parity' = reference-exact sequential
    # update (training).
    update_mode: str = "fast"
    # Orthogonality / transR projection loop cap (TransH/TransR training).
    projection_max_iters: int = 16
    # Row-update scatter lowering: 'direct' or 'dedup' (training).
    scatter_mode: str = "direct"
    # Parity-mode implementation.  The port has one, the hand-written
    # sequential-update kernel (its plain version on CPU tensors): 'auto' and
    # 'pallas' both select it; 'scan' is refused on the card (training).
    parity_impl: str = "auto"
    # Diagnostic ablation of the TPU package's TransR chunk pipeline; kept so
    # configs round-trip, never read here.
    debug_ablate: str = ""
    # Optional mesh axis sizes for distributed runs; None = single device.
    data_axis: Optional[int] = None
    model_axis: Optional[int] = None

    # --- PTransE path-modelling knobs ---
    path_composition: str = "add"
    path_weight: float = 1.0
    path_margin: float = 1.0
    max_paths: int = 8
    path_length: int = 2
    path_min_conf: float = 0.01
    path_max_branch: int = 0

    def resolved_seed(self) -> int:
        return int(time.time()) if self.seed is None else int(self.seed)

    @property
    def method_name(self) -> str:
        return C.Method.from_any(self.method).tag

    def replace(self, **kw) -> "EmbeddingConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        """Human-readable echo, analogous to EmbeddingArguments::to_string
        (common/args.cpp:34-53)."""
        m = C.Method.from_any(self.method).tag
        sm = C.Method.from_any(self.seed_method).tag
        return (
            f"Options: [datadir: '{self.data_dir}', outdir: '{self.output_dir}', "
            f"size: {self.embedding_size}, rate: {self.learning_rate:.6f}, "
            f"margin: {self.margin:.6f}, method: {m}, "
            f"batches: {self.num_batches}, epochs: {self.max_epochs}, "
            f"distance: {int(self.distance)}, seeddatadir: '{self.seed_data_dir}', "
            f"seedmethod: {sm}, seed: {self.resolved_seed()}]"
        )
