"""Reference-compatible text embedding files.

Byte-compatible with ``Trainer::write`` (``common/trainer.cpp:109-127``) and
with ``kb2e_tpu.io.text``: each row is ``%.6lf\t`` per value followed by
``\n``; files are ``entity2vec.{unif|bern}`` and ``relation2vec.{unif|bern}``;
TransH adds ``weights.{method}`` with one [k] row per relation; TransR writes
its [R, k, k] weights as R·k lines of k values.

Readers accept any whitespace-separated float layout, like the reference's
``fscanf("%lf")`` loops (common/evaluation.cpp:74-105).  Because that format
silently misparses when ``--size`` disagrees with the trained files (quirk
B11), writers also drop a JSON sidecar with the shapes, and readers validate
against it when present.  Everything here is host-side numpy;
:mod:`kb2e_tpu_torch.convert` moves the arrays to and from tensors.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from kb2e_tpu_torch import constants as C
from kb2e_tpu_torch.constants import Method

SIDECAR_NAME = "embedding_meta.json"


def _fmt_row(row: np.ndarray) -> str:
    return "".join(f"{v:.6f}\t" for v in row) + "\n"


def write_matrix(path: str, mat: np.ndarray) -> None:
    """Write a 2-D matrix in the reference row format."""
    mat = np.asarray(mat, dtype=np.float64)
    with open(path, "w", encoding="utf-8") as f:
        for row in mat:
            f.write(_fmt_row(row))


def read_matrix(path: str, rows: int, cols: int) -> np.ndarray:
    """Read ``rows``×``cols`` floats, fscanf-style (whitespace-separated)."""
    with open(path, "r", encoding="utf-8") as f:
        values = np.array(f.read().split(), dtype=np.float64)
    expected = rows * cols
    if values.size < expected:
        raise ValueError(
            f"{path}: expected at least {expected} values ({rows}x{cols}), got {values.size}"
        )
    return values[:expected].reshape(rows, cols)


def _sidecar_path(out_dir: str) -> str:
    return os.path.join(out_dir, SIDECAR_NAME)


def write_embeddings(
    out_dir: str,
    method: Method,
    entity: np.ndarray,
    relation: np.ndarray,
    weights: Optional[np.ndarray] = None,
    model_name: str = "",
    extras: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write entity/relation(/weights) files exactly like the reference.

    ``extras`` (e.g. CTransR's cluster vectors/centers, which have no
    reference counterpart) are written as ``<name>.<tag>`` in the same row
    format, with their shapes recorded in the sidecar.
    """
    os.makedirs(out_dir, exist_ok=True)
    tag = Method.from_any(method).tag
    write_matrix(os.path.join(out_dir, f"{C.RELATION_EMBEDDING_BASENAME}.{tag}"), relation)
    write_matrix(os.path.join(out_dir, f"{C.ENTITY_EMBEDDING_BASENAME}.{tag}"), entity)

    meta: Dict = {
        "model": model_name,
        "method": tag,
        "entity_shape": list(np.asarray(entity).shape),
        "relation_shape": list(np.asarray(relation).shape),
    }
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        meta["weights_shape"] = list(w.shape)
        # TransH: [R, k] one line per relation; TransR: [R, k, k] flattened to
        # R·k lines of k values (transr/trainer.cpp:128-142).
        flat = w.reshape(-1, w.shape[-1])
        write_matrix(os.path.join(out_dir, f"{C.WEIGHT_EMBEDDING_BASENAME}.{tag}"), flat)
    if extras:
        meta["extras"] = {}
        for name, arr in extras.items():
            arr = np.asarray(arr, dtype=np.float64)
            meta["extras"][name] = list(arr.shape)
            write_matrix(os.path.join(out_dir, f"{name}.{tag}"), arr.reshape(-1, arr.shape[-1]))
    with open(_sidecar_path(out_dir), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)


def read_sidecar(out_dir: str) -> Optional[Dict]:
    p = _sidecar_path(out_dir)
    if not os.path.exists(p):
        return None
    with open(p, "r", encoding="utf-8") as f:
        return json.load(f)


def read_embeddings(
    out_dir: str,
    method: Method,
    n_entities: int,
    n_relations: int,
    embedding_size: int,
    weights_shape: Optional[tuple] = None,
) -> Dict[str, np.ndarray]:
    """Load embeddings written by either package or the reference binaries.

    ``weights_shape``: (R, k) for TransH, (R, k, k) for TransR, None otherwise.
    Validates against the JSON sidecar when one exists (fixing quirk B11).
    """
    tag = Method.from_any(method).tag
    meta = read_sidecar(out_dir)
    if meta is not None:
        if meta.get("entity_shape") and meta["entity_shape"] != [n_entities, embedding_size]:
            raise ValueError(
                f"{out_dir}: sidecar says entity shape {meta['entity_shape']}, "
                f"caller expects {[n_entities, embedding_size]} — check --size"
            )

    out = {
        "entity": read_matrix(
            os.path.join(out_dir, f"{C.ENTITY_EMBEDDING_BASENAME}.{tag}"),
            n_entities,
            embedding_size,
        ),
        "relation": read_matrix(
            os.path.join(out_dir, f"{C.RELATION_EMBEDDING_BASENAME}.{tag}"),
            n_relations,
            embedding_size,
        ),
    }
    if weights_shape is not None:
        rows = int(np.prod(weights_shape[:-1]))
        flat = read_matrix(
            os.path.join(out_dir, f"{C.WEIGHT_EMBEDDING_BASENAME}.{tag}"),
            rows,
            weights_shape[-1],
        )
        out["weights"] = flat.reshape(weights_shape)
    if meta is not None:
        for name, shape in meta.get("extras", {}).items():
            rows = int(np.prod(shape[:-1]))
            flat = read_matrix(os.path.join(out_dir, f"{name}.{tag}"), rows, shape[-1])
            out[name] = flat.reshape(shape)
    return out


def entity_norm_warnings(entity: np.ndarray, tol: float = 1e-3) -> int:
    """Count rows violating the unit-norm sanity check the reference warns
    about at load (common/evaluation.cpp:99-102)."""
    norms = np.linalg.norm(entity, axis=1)
    return int(np.sum(norms - 1.0 > tol))
