"""ctypes binding to the native PCRA path extractor (counterpart of ``kb2e_tpu/data/native_paths.py``).

The extractor is ``native/path_extract.cpp`` at the root of the checkout,
compiled as it stands by ``data/native.py::build`` (``g++ -O2 -std=c++17
-shared -fPIC``, the JAX package's flags, so both libraries compute the same
bits) into ``build/native/libkb2e_paths_<hash>.so``.  The JAX package writes
its library beside its module; this one never writes there.  When the build
or the ``dlopen`` fails, the reason is printed once to stderr and
:func:`available` is False: ``data/paths.py::build_path_store`` then runs the
Python extractor, unless the caller forced the native one.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from typing import Optional

import numpy as np

from kb2e_tpu_torch.data import native

SOURCE = native.ROOT / "native" / "path_extract.cpp"
STEM = "libkb2e_paths"


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None after printing why it is not there."""
    try:
        lib = ctypes.CDLL(str(native.build(SOURCE, native.BUILD_DIR, STEM)))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        print(f"kb2e_paths: native extractor unavailable ({exc}); using the Python extractor", file=sys.stderr)
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.kb2e_extract_paths.restype = ctypes.c_int
    lib.kb2e_extract_paths.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64,
        i32p, i32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS,WRITEABLE"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS,WRITEABLE"),
    ]
    return lib


def available() -> bool:
    """True if the native extractor is built and loaded (building it at first call)."""
    return _library() is not None


def extract_path_arrays(
    heads: np.ndarray,
    tails: np.ndarray,
    rels: np.ndarray,
    n_entities: int,
    n_relations: int,
    max_len: int = 2,
    min_conf: float = 0.01,
    max_paths: int = 8,
    max_branch: int = 0,
    query_pairs=None,
):
    """Native PCRA over the (heads, tails, rels) graph for each query pair
    (default: the graph's own pairs); returns (rels [Q, P, L] int32,
    conf [Q, P] float32)."""
    lib = _library()
    if lib is None:
        raise RuntimeError("native path extractor unavailable")
    h = np.ascontiguousarray(heads, dtype=np.int32)
    t = np.ascontiguousarray(tails, dtype=np.int32)
    r = np.ascontiguousarray(rels, dtype=np.int32)
    qh, qt = (h, t) if query_pairs is None else (
        np.ascontiguousarray(query_pairs[0], dtype=np.int32),
        np.ascontiguousarray(query_pairs[1], dtype=np.int32),
    )
    nq = qh.shape[0]
    out_rels = np.empty((nq, max_paths, max_len), dtype=np.int32)
    out_conf = np.empty((nq, max_paths), dtype=np.float32)
    rc = lib.kb2e_extract_paths(
        h, t, r, h.shape[0], qh, qt, nq, int(n_entities), int(n_relations),
        int(max_len), float(min_conf), int(max_paths), int(max_branch),
        out_rels.reshape(-1), out_conf.reshape(-1),
    )
    if rc != 0:
        raise RuntimeError(f"native path extractor failed (rc={rc})")
    return out_rels, out_conf
