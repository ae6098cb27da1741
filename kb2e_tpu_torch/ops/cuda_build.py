"""Builds the hand-written CUDA kernels of ``csrc/`` with ``nvcc``.

Each source is compiled on its own, for ``sm_90a``, into a shared library
with a plain C interface that the kernel's wrapper loads with ``ctypes``.
The library lands in ``build/kernels/`` at the root of the checkout, at first
use, under a name that carries a hash of the source, the headers of
``csrc/`` and the flags, so an edited source or header is rebuilt and an
unchanged one is not.  nvcc's output, with
ptxas's register and spill report for each kernel, is kept beside the
library as ``.log``.  The wrappers share the checks of what a library's
launchers return, and one count of the kernels they launch,
``launch_counts``, keyed by kernel name.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",  # -v: ptxas reports each kernel's registers and spills
    "-v",
)

# Kernel launches by kernel name; the wrappers add to it only where a kernel
# is launched.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Where the build of ``source`` with the current flags lives: the hash
    covers the source, the headers beside it and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"{source.stem}_{digest}.so"


def build(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless this source is built already; returns the library."""
    so = library_path(source, build_dir)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def device_index(dev: torch.device) -> int:
    """The CUDA ordinal of ``dev``; the current device where it names none."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raises RuntimeError unless ``code``, the CUDA error code one of
    ``lib``'s launchers returned, is 0 (the launch was accepted)."""
    if code != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {lib.kb2e_cuda_error_string(code).decode()} (cuda error {code})"
        )


def blocks_per_sm(lib: ctypes.CDLL, query, k: int, device, what: str) -> int:
    """Blocks of an update pass that fit on one SM of ``device`` (default
    ``cuda``) at width k, as ``query``, one of ``lib``'s
    ``kb2e_<name>_blocks_per_sm``, reports them."""
    per_sm = ctypes.c_int(0)
    check_launch(lib, query(k, device_index(torch.device(device or "cuda")), ctypes.byref(per_sm)), what)
    return per_sm.value
