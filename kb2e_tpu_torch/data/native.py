"""ctypes binding to the native C++ triple loader (counterpart of ``kb2e_tpu/data/native.py``).

The loader is ``native/io_loader.cpp`` at the root of the checkout, compiled
as it stands with ``g++ -O2 -std=c++17 -shared -fPIC`` at first use into
``build/native/``, under a name that carries a hash of the source and the
flags.  The compiler writes a file of its own and ``os.replace`` moves it into
place, so processes that build at the same moment never load a half-written
library.  When the build or the ``dlopen`` fails, the reason is printed once
to stderr and :func:`available` is False: ``data/triples.py::load_dataset``
then parses with the Python loader, as ``kb2e_tpu`` does (silently there).

The loader re-reads the id maps from the triple file's directory (the
reference keeps them together, common/constants.h:19-23); it takes the
caller's dicts only to check the entity count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import uuid
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from kb2e_tpu_torch import constants as C

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "io_loader.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR, stem: str = "libkb2e_io") -> Path:
    """Where the build of ``source`` with ``FLAGS`` lives: ``<stem>_<hash>.so``."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"{stem}_{digest}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR, stem: str = "libkb2e_io") -> Path:
    """Compile ``source`` unless it is built already; returns the library.
    Raises ``OSError`` (no compiler, no source) or ``RuntimeError`` (g++ failed).
    ``data/native_paths.py`` builds ``native/path_extract.cpp`` through it."""
    so = library_path(source, build_dir, stem)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{uuid.uuid4().hex}.tmp")  # one per caller, thread or process
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None after printing why it is not there."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        print(f"kb2e_io: native loader unavailable ({exc}); using the Python loader", file=sys.stderr)
        return None
    i32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
    lib.kb2e_load_triples.restype = ctypes.c_long
    lib.kb2e_load_triples.argtypes = [ctypes.c_char_p] * 3 + [i32pp] * 3 + [ctypes.POINTER(ctypes.c_long)] * 2
    lib.kb2e_free.restype = None
    lib.kb2e_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True if the native loader is built and loaded (building it at first call)."""
    return _library() is not None


def load_triple_file(
    path: str,
    entity2id: Dict[str, int],
    relation2id: Dict[str, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native parse of a triple file into int32 (heads, tails, rels), with the
    Python loader's signature; rows with unknown ids are warned about on
    stderr and skipped, as ``data/triples.py::load_triple_file`` does."""
    lib = _library()
    if lib is None:
        raise RuntimeError("the native loader is unavailable")
    data_dir = os.path.dirname(os.path.abspath(path))
    ptrs = [ctypes.POINTER(ctypes.c_int32)() for _ in range(3)]
    n_ent, n_rel = ctypes.c_long(), ctypes.c_long()
    n = lib.kb2e_load_triples(
        os.path.join(data_dir, C.ENTITY_ID_FILE).encode(), os.path.join(data_dir, C.RELATION_ID_FILE).encode(),
        path.encode(), *(ctypes.byref(p) for p in ptrs), ctypes.byref(n_ent), ctypes.byref(n_rel),
    )
    if n < 0:
        raise RuntimeError(f"native loader failed on {path}")
    try:
        if len(entity2id) and n_ent.value != len(entity2id):
            raise ValueError(f"{path}: native loader saw {n_ent.value} entities, caller has {len(entity2id)}")
        return tuple(np.ctypeslib.as_array(p, shape=(n,)).copy() if n else np.zeros(0, np.int32) for p in ptrs)
    finally:
        for p in ptrs:
            lib.kb2e_free(p)
