"""Rank-count sweep for link-prediction eval: a hand-written CUDA kernel.

Counterpart of ``kb2e_tpu/ops/pallas_rank.py::rank_counts``.  For each query
it counts the entities that rank before the true one — the count form of the
reference's sort-and-scan (common/evaluation.cpp:124-179) — in one pass over
the entity table, without a [B, N] score matrix in device memory.

The public layout is the JAX function's: the entity table and the queries
come transposed, ``proj_t`` [k, N] and ``queries_t`` [k, B].  Unlike the TPU
kernel, the CUDA kernel takes the real N and B and masks the ragged edges
itself; no 1e30 pad rows reach it.

* On a CUDA tensor :func:`rank_counts` launches the kernel of
  ``csrc/rank_count.cu`` (L1 and L2 templates of one kernel; what bounds it
  and how it is built is noted in that file), or raises.  The kernel is
  compiled with ``nvcc`` for ``sm_90a`` at first use, into ``build/kernels/``
  at the root of the checkout, and bound with ``ctypes``.
* On a CPU tensor it runs :func:`rank_counts_reference`, the plain PyTorch
  version: the blockwise sweep of ``ranking.rank_queries``, summing over k
  in the kernel's order.

``launch_counts`` counts the kernel's launches per distance; only the launch
path adds to it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import distances

KERNEL_NAMES = {Distance.L1: "rank_count_l1", Distance.L2: "rank_count_l2"}
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rank_count.cu"
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

# Kernel launches by kernel name, added to only where a kernel is launched.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the rank-count kernel cannot be built")
    return found


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"rank_count_{digest}.so"


def build() -> Path:
    """Compile ``csrc/rank_count.cu`` unless this source is built already.

    nvcc's output, with ptxas's register and spill report for each kernel,
    is kept beside the library as ``.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.kb2e_rank_count.argtypes = [ptr] * 7 + [c_int] * 5 + [ptr]
    lib.kb2e_rank_count.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def beats(en: torch.Tensor, idx: torch.Tensor, e_true: torch.Tensor, true_idx: torch.Tensor) -> torch.Tensor:
    """Does entity ``idx`` rank before the true entity (ties broken by id)?

    Counterpart of ``pallas_rank._beats_count`` and ``ranking._beats``.  The
    self-comparison j == true is excluded explicitly rather than relying on
    E_j == E_true: the sweep computes energies another way (one k-row at a
    time; the L2 expansion) than the direct true-energy formula, and the true
    entity must never outrank itself.
    """
    t = true_idx[:, None]
    e = e_true[:, None]
    return (idx != t) & ((en < e) | ((en == e) & (idx < t)))


def rank_counts_reference(
    proj_t: torch.Tensor,  # [k, N] transposed projected entity table
    queries_t: torch.Tensor,  # [k, B] transposed queries
    e_true: torch.Tensor,  # [B] true energies (direct residual formula)
    true_idx: torch.Tensor,  # int [B]
    distance: Distance,
    block_size: int = 4096,
) -> torch.Tensor:
    """Plain PyTorch version: int32 [B], the entities ranking before the true one.

    Sweeps the entity axis in blocks of ``block_size`` rows (the last block
    short), scoring each block with ``distances.pairwise_energy``, which sums
    over k in the kernel's order; L2's squared norms are the ones the kernel
    gets, so on the same inputs the two give the same counts.
    """
    entities, queries = proj_t.T, queries_t.T
    n = entities.shape[0]
    e_sq = q_sq = None
    if distance == Distance.L2:
        e_sq, q_sq = distances.squared_norms(proj_t), distances.squared_norms(queries_t)
    count = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    for start in range(0, n, block_size):
        stop = min(start + block_size, n)
        en = distances.pairwise_energy(
            entities[start:stop], queries, distance,
            e_sq=None if e_sq is None else e_sq[start:stop], q_sq=q_sq,
        )  # [B, blk]
        idx = torch.arange(start, stop, device=entities.device)[None, :]
        count += torch.sum(beats(en, idx, e_true, true_idx), dim=1, dtype=torch.int32)
    return count


def rank_counts(
    proj_t: torch.Tensor,  # [k, N] float32, contiguous
    queries_t: torch.Tensor,  # [k, B] float32, contiguous
    e_true: torch.Tensor,  # [B] float32
    true_idx: torch.Tensor,  # [B] int32
    distance: Distance,
    block_size: int = 4096,
) -> torch.Tensor:
    """int32 [B]: number of entities ranking before the true one.

    CUDA tensors go to the kernel (``block_size`` is then unused: the kernel
    tiles the entity axis itself); CPU tensors to the plain version.
    """
    distance = Distance(distance)
    dev = proj_t.device
    if dev.type == "cpu":
        return rank_counts_reference(proj_t, queries_t, e_true, true_idx, distance, block_size)
    if dev.type != "cuda":
        raise ValueError(f"rank_counts: no kernel for device {dev}")
    k, n = proj_t.shape
    b = queries_t.shape[1]
    for name, x, dtype, shape in (
        ("proj_t", proj_t, torch.float32, (k, n)),
        ("queries_t", queries_t, torch.float32, (k, b)),
        ("e_true", e_true, torch.float32, (b,)),
        ("true_idx", true_idx, torch.int32, (b,)),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"rank_counts: {name} must be a contiguous {dtype} tensor of shape {shape} on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if max(k * n, k * b) >= 2**31:
        raise ValueError(f"rank_counts: [k, N] = {[k, n]} or [k, B] = {[k, b]} exceeds the kernel's int range")

    out = torch.zeros(b, dtype=torch.int32, device=dev)
    e_sq = q_sq = None
    if distance == Distance.L2:
        e_sq, q_sq = distances.squared_norms(proj_t), distances.squared_norms(queries_t)
    lib = _library()
    code = lib.kb2e_rank_count(
        proj_t.data_ptr(),
        queries_t.data_ptr(),
        e_true.data_ptr(),
        true_idx.data_ptr(),
        None if e_sq is None else e_sq.data_ptr(),
        None if q_sq is None else q_sq.data_ptr(),
        out.data_ptr(),
        k,
        n,
        b,
        int(distance == Distance.L2),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"rank-count kernel launch failed: {lib.kb2e_cuda_error_string(code).decode()} (cuda error {code})"
        )
    launch_counts[KERNEL_NAMES[distance]] += 1
    return out
