"""TransR's fast chunk on the fused [N+R, k] table and W: one hand-written cooperative CUDA kernel a run of chunks.

One chunk of ``models/transr.py::TransR.chunk_update_``: from the chunk-start
tables, the violating samples' closed-form steps added into W, the entity and
the relation rows; every touched row sphere-normed once; then one masked
step of the ‖a·W‖ ≤ 1 descent on each violating sample's four pairs.  No
Pallas kernel is replaced: the JAX package's fast update is XLA ops.

* :class:`FusedChunks` applies the chunks of an epoch's [n, chunk] feed in
  order, in place on a float32 fused table and ``proj`` [R, k, k].
* Consecutive calls queue their chunks, and one ``ctypes`` call launches
  up to ``RUN`` of them as one cooperative kernel of ``csrc/transr_fast.cu``
  (what bounds it and its design are noted there):
  four phases a chunk (score, steps and norms, the descent's step, its
  adds), a grid-wide barrier after each.  The kernel is compiled by
  :mod:`kb2e_tpu_torch.ops.cuda_build` at first use; a call passes pointers
  into the feed and makes no torch call.  The tables must lie on a CUDA
  device: elsewhere ``TransR.chunk_update_`` is the chunk (its eager chunks).

The kernel rounds every operation as ``chunk_update_`` rounds it, sums rows
as torch's CUDA row sum does and its dot products in the orders cuBLAS's
kernels use for ``chunk_update_``'s products where they were probed (k 50,
chunks of 256 on an H100), and adds a row's steps one by one in slot order,
where ``index_add`` adds them in the order its atomics land.  So the two
agree bit for bit where every such sum is exact (dyadic tables), and
otherwise part by an ulp here and there where an order differs.

Each launch adds one to ``cuda_build.launch_counts`` under the kernel's
name; only the launch path adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from kb2e_tpu_torch.ops import cuda_build

KERNEL_NAMES = ("transr_fast_chunks",)
SOURCE = cuda_build.CSRC / "transr_fast.cu"
BUILD_DIR = cuda_build.BUILD_DIR
WHAT = "TransR fast-chunk"  # names the kernel in launch errors
MAX_K = 128  # 4 coordinates a lane
MAX_ROWS = 512  # samples a chunk: the kernel stages their relations in shared memory
RUN = 64  # chunks a launch runs at most
ID_KEYS = ("ph", "pt", "r", "nh", "nt")


def build() -> Path:
    """Compile ``csrc/transr_fast.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kb2e_transr_fast_chunks.argtypes = [ptr] * 22 + [c_int] * 9 + [c_float, c_float, ptr]
    lib.kb2e_transr_fast_chunks.restype = c_int
    lib.kb2e_transr_fast_grid.argtypes = [c_int, c_int, c_int, ctypes.POINTER(c_int)]
    lib.kb2e_transr_fast_grid.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def takes(k: int, rows: int) -> bool:
    """Whether the kernel takes tables of width ``k`` and chunks of ``rows``
    samples: a lane holds at most 4 coordinates, and a chunk's relations fit
    in shared memory."""
    return 0 < k <= MAX_K and 0 < rows <= MAX_ROWS


class FusedChunks:
    """The chunks of a [n, chunk] feed applied in order, in place on ``table`` and ``proj``.

    ``table`` is the fused [N+R, k] float32 table (relation row ids offset by
    ``n_entities``) and ``proj`` the [R, k, k] float32 matrices, both
    contiguous; ``chunks`` holds ph, pt, r, nh, nt and valid, [n, chunk] each.
    Calling the object with i applies chunk i; the chunks must be applied in
    order.  ``loss`` [n] holds each applied chunk's loss, and ``params()``
    gives the entity and relation rows of ``table`` and ``proj``.  A call
    queues its chunk: consecutive chunks run as one launch of up to ``RUN``
    of them, and reading ``loss`` or ``params()`` (or :meth:`flush`)
    launches what is queued.

    The tables must lie on a CUDA device; any other raises.  The kernel reads
    the feed where it lies when its ids are int32 and ``valid`` bool,
    contiguous, as the sampler draws them (any other feed is converted
    once), so the caller leaves the feed unchanged until the last call.
    """

    def __init__(self, table: torch.Tensor, proj: torch.Tensor, n_entities: int, chunks: Dict[str, torch.Tensor], *,
                 learning_rate: float, margin: float, l1: bool):
        dev = table.device
        n_rows, k = table.shape
        n, rows = chunks["ph"].shape
        n_relations = n_rows - n_entities
        for name, t in (("table", table), ("proj", proj)):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"transr_fast: {name} must be a contiguous float32 tensor on {dev}, "
                                 f"got {t.dtype} on {t.device}")
        if not takes(k, rows) or n_rows >= 2**31 or not 0 < n_entities < n_rows:
            raise ValueError(f"transr_fast: k = {k} must lie in [1, {MAX_K}], a chunk hold 1 to {MAX_ROWS} "
                             f"samples (got {rows}) and the table hold entities and relations")
        if tuple(proj.shape) != (n_relations, k, k):
            raise ValueError(f"transr_fast: proj must be of shape {(n_relations, k, k)}, got {tuple(proj.shape)}")
        for key in (*ID_KEYS, "valid"):
            x = chunks[key]
            if x.device != dev or tuple(x.shape) != (n, rows):
                raise ValueError(f"transr_fast: {key} must be of shape {(n, rows)} on {dev}, "
                                 f"got {tuple(x.shape)} on {x.device}")
        if dev.type != "cuda":
            raise ValueError(f"transr_fast: no kernel for device {dev}")
        self.table, self.proj, self.n, self.n_entities = table, proj, n, n_entities
        self._loss = torch.zeros(n, dtype=torch.float32, device=dev)
        self.queued = (0, 0)  # the chunks called for and not yet launched: (first, count)
        self.launched = 0  # chunks run on this scratch: the parity of the next one's counts
        # Everything but the chunk's offsets, once: a call only adds them.
        self.chunks = {key: chunks[key].to(torch.bool if key == "valid" else torch.int32).contiguous()
                       for key in (*ID_KEYS, "valid")}
        self.lib, self.rows = _library(), rows
        self.ids = [self.chunks[key].data_ptr() for key in (*ID_KEYS, "valid")]
        # A chunk's scratch: each sample's decision, loss, steps (x+, x−,
        # h − t, h' − t', W x+, W x−) and relation's first sample, the lists
        # of first samples and of violators and their counts, each sample's
        # pairs' decisions, rows, tmp and deltas; by relation the samples
        # that step its W_r, by row the slots that step it, and its owner.
        self.viol = torch.empty(rows, dtype=torch.uint8, device=dev)
        self.sample_loss = torch.empty(rows, dtype=torch.float32, device=dev)
        self.step = torch.empty(rows, 6, k, dtype=torch.float32, device=dev)
        self.first_of = torch.empty(rows, dtype=torch.int32, device=dev)
        self.firsts = torch.empty(rows, 2, dtype=torch.int32, device=dev)
        self.violators = torch.empty(rows, 5, dtype=torch.int32, device=dev)
        self.counts = torch.zeros(2, 2, dtype=torch.int32, device=dev)
        self.act = torch.empty(rows, 4, dtype=torch.uint8, device=dev)
        self.ball = torch.empty(rows, 12, k, dtype=torch.float32, device=dev)
        self.w_masks = torch.zeros(2, rows, (rows + 31) // 32, dtype=torch.int32, device=dev)
        self.row_masks = torch.zeros(n_rows, (4 * rows + 31) // 32, dtype=torch.int32, device=dev)
        self.owner = torch.full((n_rows,), 2**31 - 1, dtype=torch.int32, device=dev)
        self.scratch = tuple(t.data_ptr() for t in (self.viol, self.sample_loss, self.step, self.first_of, self.firsts,
                                                    self.violators, self.counts, self.act, self.ball, self.w_masks,
                                                    self.row_masks, self.owner))
        self.stamps = None  # a [n, 5] int64 tensor: the card's clock as each chunk starts and its phases end
        device, blocks = cuda_build.device_index(dev), ctypes.c_int(0)
        cuda_build.check_launch(self.lib, self.lib.kb2e_transr_fast_grid(k, int(l1), device, ctypes.byref(blocks)),
                                WHAT)
        self.blocks = blocks.value  # the grid: every block that fits on the card at once
        self.tail = (rows, k, n_entities, n_relations, int(l1), device, self.blocks, float(learning_rate),
                     float(margin), torch.cuda.current_stream(dev).cuda_stream)

    def __call__(self, i: int) -> None:
        if not 0 <= i < self.n:
            raise IndexError(f"transr_fast: chunk {i} of {self.n}")
        first, count = self.queued
        if i != first + count:
            self.flush()
            first, count = i, 0
        self.queued = (first, count + 1)
        if count + 1 == RUN:
            self.flush()

    def flush(self) -> None:
        """Launches the chunks called for since the last launch, as one run."""
        first, count = self.queued
        if count == 0:
            return
        self.queued = (0, 0)
        lib, at = self.lib, first * self.rows
        ph, pt, r, nh, nt, valid = self.ids
        cuda_build.check_launch(lib, lib.kb2e_transr_fast_chunks(
            self.table.data_ptr(), self.proj.data_ptr(), ph + 4 * at, pt + 4 * at, r + 4 * at, nh + 4 * at,
            nt + 4 * at, valid + at, *self.scratch, self._loss.data_ptr() + 4 * first,
            None if self.stamps is None else self.stamps[first].data_ptr(), count, self.launched & 1, *self.tail),
            WHAT)
        self.launched += count
        for name in KERNEL_NAMES:
            cuda_build.launch_counts[name] += 1

    @property
    def loss(self) -> torch.Tensor:
        """[n]: each applied chunk's loss."""
        self.flush()
        return self._loss

    def params(self) -> Dict[str, torch.Tensor]:
        """``table``'s entity and relation rows, as views, and ``proj``."""
        self.flush()
        return {"entity": self.table[:self.n_entities], "relation": self.table[self.n_entities:], "proj": self.proj}
