"""Rank-count sweep for link-prediction eval: a hand-written CUDA kernel.

Counterpart of ``kb2e_tpu/ops/pallas_rank.py::rank_counts``.  For each query
it counts the entities that rank before the true one — the count form of the
reference's sort-and-scan (common/evaluation.cpp:124-179) — in one pass over
the entity table, without a [B, N] score matrix in device memory.

The public layout is the JAX function's: the entity table and the queries
come transposed, ``proj_t`` [k, N] and ``queries_t`` [k, B].  Unlike the TPU
kernel, the CUDA kernel takes the real N and B and masks the ragged edges
itself; no 1e30 pad rows reach it.  It copies its tiles in with 16-byte
``cp.async``, so it takes rows 16-byte aligned: a [k, M] operand whose
leading dimension is a multiple of 4 floats (:func:`kernel_takes`).
:func:`aligned_transpose` builds such a table (pad columns unset, masked by
the kernel), as the eval harness does once per group; the wrapper pads a
copy of any other.  :func:`plan` holds the kernel's tile and grid
arithmetic.

* On a CUDA tensor :func:`rank_counts` launches the kernel of
  ``csrc/rank_count.cu`` (L1 and L2 templates of one kernel; what bounds it
  is noted in that file), or raises.  The kernel is compiled by
  :mod:`kb2e_tpu_torch.ops.cuda_build` at first use and bound with ``ctypes``.
* On a CPU tensor it runs :func:`rank_counts_reference`, the plain PyTorch
  version: the blockwise sweep of ``ranking.rank_queries``, summing over k
  in the kernel's order.

Each launch adds one to ``cuda_build.launch_counts`` under the kernel's
name, per distance; only the launch path adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import cuda_build, distances

KERNEL_NAMES = {Distance.L1: "rank_count_l1", Distance.L2: "rank_count_l2"}
SOURCE = cuda_build.CSRC / "rank_count.cu"
BUILD_DIR = cuda_build.BUILD_DIR

# The kernel's block tile (BlockTile in csrc/rank_count.cu): threads along
# the entities and along the queries, the entities and the queries a thread
# owns, the lanes of a warp along the entities, and the ring: k-rows a
# chunk, chunks (stages) it holds.  128 entities x 256 queries, 512 threads.
TILE = (16, 32, 8, 8, 8, 16, 3)


class Plan(NamedTuple):
    """One launch's tiling, as the kernel computes it."""

    tile_n: int  # entities of a block
    tile_b: int  # queries of a block
    threads: int  # threads of a block
    chunk: int  # k-rows of a chunk
    stages: int  # chunks the ring holds
    grid: Tuple[int, int]  # blocks along the entities, along the queries
    chunks: int  # k-chunks, the last one short
    tail_k: int  # k-rows of the last chunk
    tail_n: int  # entities of the last block along the entities
    tail_b: int  # queries of the last block along the queries

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def smem_bytes(self) -> int:
        """The ring's dynamic shared memory a block."""
        return 4 * self.stages * self.chunk * (self.tile_n + self.tile_b)

    def waves(self, blocks_per_sm: int, sms: int) -> float:
        """Blocks over the blocks the card holds at once."""
        return self.blocks / (blocks_per_sm * sms)


def plan(k: int, n: int, b: int) -> Plan:
    """The kernel's tiling of a [k, n] table against [k, b] queries."""
    tx, ty, per_e, per_q, _, chunk, stages = TILE
    tile_n, tile_b = per_e * tx, per_q * ty
    grid = (-(-n // tile_n), -(-b // tile_b))
    chunks = -(-k // chunk)
    return Plan(tile_n, tile_b, tx * ty, chunk, stages, grid, chunks, k - chunk * (chunks - 1) if k else 0,
                n - tile_n * (grid[0] - 1), b - tile_b * (grid[1] - 1))


def padded_ld(m: int) -> int:
    """The leading dimension the kernel takes for m columns: m rounded up to 4 floats."""
    return -(-m // 4) * 4


def aligned_transpose(x: torch.Tensor) -> torch.Tensor:
    """[k, M] view of ``x.T`` ([M, k]) with the leading dimension
    ``padded_ld(M)``: the layout the kernel takes without a copy.  The pad
    columns are left unset: the kernel copies them in with their row but
    masks them (j >= n), and no count reads them."""
    m, k = x.shape
    out = torch.empty((k, padded_ld(m)), dtype=x.dtype, device=x.device)[:, :m]
    out.copy_(x.T)
    return out


def kernel_takes(x_t: torch.Tensor) -> bool:
    """Does the kernel read this [k, M] float32 operand as it is?  Rows
    contiguous, 16-byte aligned and a multiple of 4 floats apart, and the
    storage holds the last row up to column ``padded_ld(M)``."""
    k, m = x_t.shape
    ld, step = x_t.stride()
    if k <= 1:
        ld = padded_ld(m)
    if step != 1 or ld % 4 or ld < m or x_t.data_ptr() % 16:
        return False
    last = x_t.storage_offset() + (k - 1) * ld + padded_ld(m) if k else 0
    return last * x_t.element_size() <= x_t.untyped_storage().nbytes()


def build() -> Path:
    """Compile ``csrc/rank_count.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.kb2e_rank_count.argtypes = [ptr] * 7 + [c_int] * 7 + [ptr]
    lib.kb2e_rank_count.restype = c_int
    lib.kb2e_rank_count_blocks_per_sm.argtypes = [c_int, c_int, ptr]
    lib.kb2e_rank_count_blocks_per_sm.restype = c_int
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
    e_sq: Optional[torch.Tensor] = None,  # [N] ‖e‖² of proj_t's columns, L2 only
) -> torch.Tensor:
    """Plain PyTorch version: int32 [B], the entities ranking before the true one.

    Sweeps the entity axis in blocks of ``block_size`` rows (the last block
    short), scoring each block with ``distances.pairwise_energy``, which sums
    over k in the kernel's order; L2's squared norms are the ones the kernel
    gets (``e_sq`` where the caller gives it, else ``squared_norms(proj_t)``
    as the wrapper computes it), so on the same inputs the two give the same
    counts.
    """
    entities, queries = proj_t.T, queries_t.T
    n = entities.shape[0]
    q_sq = None
    if distance == Distance.L2:
        e_sq = distances.squared_norms(proj_t) if e_sq is None else e_sq
        q_sq = distances.squared_norms(queries_t)
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
    proj_t: torch.Tensor,  # [k, N] float32, rows contiguous
    queries_t: torch.Tensor,  # [k, B] float32, rows contiguous
    e_true: torch.Tensor,  # [B] float32
    true_idx: torch.Tensor,  # [B] int32
    distance: Distance,
    block_size: int = 4096,
    e_sq: Optional[torch.Tensor] = None,  # [N] float32 ‖e‖² of proj_t's columns, L2 only
) -> torch.Tensor:
    """int32 [B]: number of entities ranking before the true one.

    CUDA tensors go to the kernel (``block_size`` is then unused: the kernel
    tiles the entity axis itself); CPU tensors to the plain version.  For L2
    a caller that ranks many batches against one table passes its ‖e‖²
    (``distances.squared_norms(proj_t)``) once computed; without it the
    wrapper computes the same.  ``proj_t`` and ``queries_t`` may have any
    leading dimension; the kernel reads them in place where
    :func:`kernel_takes` them, else a padded copy.
    """
    distance = Distance(distance)
    dev = proj_t.device
    if dev.type == "cpu":
        return rank_counts_reference(proj_t, queries_t, e_true, true_idx, distance, block_size, e_sq)
    if dev.type != "cuda":
        raise ValueError(f"rank_counts: no kernel for device {dev}")
    k, n = proj_t.shape
    b = queries_t.shape[1]
    l2 = distance == Distance.L2
    for name, x, dtype, shape, rows in (
        ("proj_t", proj_t, torch.float32, (k, n), True),
        ("queries_t", queries_t, torch.float32, (k, b), True),
        ("e_true", e_true, torch.float32, (b,), False),
        ("true_idx", true_idx, torch.int32, (b,), False),
        *((("e_sq", e_sq, torch.float32, (n,), False),) if l2 and e_sq is not None else ()),
    ):
        laid_out = x.stride(-1) == 1 if rows else x.is_contiguous()
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not laid_out:
            what = "tensor with contiguous rows" if rows else "contiguous tensor"
            raise ValueError(
                f"rank_counts: {name} must be a {what} of {dtype} and shape {shape} on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if max(k * padded_ld(n), k * padded_ld(b)) >= 2**31:
        raise ValueError(f"rank_counts: [k, N] = {[k, n]} or [k, B] = {[k, b]} exceeds the kernel's int range")

    out = torch.zeros(b, dtype=torch.int32, device=dev)
    q_sq = None
    if l2:
        e_sq = distances.squared_norms(proj_t) if e_sq is None else e_sq
        q_sq = distances.squared_norms(queries_t)
    proj_t, queries_t = (x if kernel_takes(x) else aligned_transpose(x.T) for x in (proj_t, queries_t))
    launcher(proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, distance)()
    return out


def launcher(proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, distance: Distance):
    """One launch on buffers :func:`rank_counts` has checked (operands that
    :func:`kernel_takes`), with its arguments bound once, on the current
    stream: each call of the returned function is a launch that adds each
    query's count into ``out``."""
    k, n = proj_t.shape
    b = queries_t.shape[1]
    dev = proj_t.device
    lib = _library()
    args = (
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
        proj_t.stride(0) if k > 1 else padded_ld(n),
        queries_t.stride(0) if k > 1 else padded_ld(b),
        int(distance == Distance.L2),
        cuda_build.device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    name = KERNEL_NAMES[distance]

    def go() -> None:
        cuda_build.check_launch(lib, lib.kb2e_rank_count(*args), "rank-count")
        cuda_build.launch_counts[name] += 1

    return go


def resident_blocks_per_sm(distance: Distance, device=None) -> int:
    """Blocks of the distance's kernel resident on one SM of ``device``
    (default ``cuda``), as the runtime reports them."""
    lib = _library()
    per_sm = ctypes.c_int(0)
    dev = torch.device(device or "cuda")
    code = lib.kb2e_rank_count_blocks_per_sm(int(Distance(distance) == Distance.L2), cuda_build.device_index(dev),
                                             ctypes.byref(per_sm))
    cuda_build.check_launch(lib, code, "rank-count")
    return per_sm.value
