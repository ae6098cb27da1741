"""TransE's fast batch on the fused [N+R, k] table: hand-written CUDA kernels, three launches a batch.

One batch of ``models/transe.py::TransE.fused_table_update`` (the
double-buffered batch of ``transe/trainer.cpp:48-56``): every row read from
the batch-start table, the violating samples' deltas added into a copy of it,
then every row of the copy ball-normed.  No Pallas kernel is replaced: the
JAX package's fast update is XLA ops.

* :class:`FusedBatches` applies the batches of an epoch's [n, rows] feed in
  order, in place on a float32 table; on the card with an accumulator that
  equals it between batches (the plain version's copy, kept instead of made
  a batch).
* On a CUDA table a call is one ``ctypes`` call that makes the three
  launches of ``csrc/transe_fast.cu`` (what bounds them and their design are
  noted there): score the batch, add its deltas into the accumulator in
  ``index_add``'s order, then ball-norm the accumulator into the table.  The
  kernels are compiled by :mod:`kb2e_tpu_torch.ops.cuda_build` at first use;
  a call passes pointers into the feed and makes no torch call.
* On a CPU table a call runs the plain version the caller passes, which is
  ``TransE.fused_table_update``, and copies its table into ``table``.

The kernels sum each row in the order of torch's CUDA row sum (k < 128) and
add every delta on its own, role by role as ``index_add`` does, so on the card
they part from ``fused_table_update`` only where its own ``index_add`` parts
from itself run to run: a few elements in ten thousand, a unit in the last
place, where a row's running sum crosses a power of two.  Both orders are
torch 2.11's, copied and not called (``csrc/transe_fast.cu`` says what a
torch with other orders changes).

Each batch on the card adds its three kernels to ``cuda_build.launch_counts``,
by name; only the launch path adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

from kb2e_tpu_torch.ops import cuda_build

KERNEL_NAMES = ("transe_fast_score", "transe_fast_scatter", "transe_fast_apply")
SOURCE = cuda_build.CSRC / "transe_fast.cu"
BUILD_DIR = cuda_build.BUILD_DIR
WHAT = "TransE fast-batch"  # names the kernels in launch errors
MAX_K = 1024  # 8 chunks of 4 coordinates a lane
ID_KEYS = ("ph", "pt", "r", "nh", "nt")


def build() -> Path:
    """Compile ``csrc/transe_fast.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kb2e_transe_fast_batch.argtypes = [ptr] * 11 + [c_int] * 7 + [c_float, c_float, ptr]
    lib.kb2e_transe_fast_batch.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def takes(k: int, rows: int) -> bool:
    """Whether the kernels take a table of width ``k`` and batches of
    ``rows`` rows: a lane holds at most 8 chunks of 4 coordinates, and a
    batch's 5·rows·k deltas are counted in 32 bits."""
    return 0 < k <= MAX_K and 0 <= rows and 5 * rows * k < 2**31


# The plain version of one batch: (table, batch) -> (the new table, the loss).
Plain = Callable[[torch.Tensor, Dict[str, torch.Tensor]], Tuple[torch.Tensor, torch.Tensor]]


class FusedBatches:
    """The batches of a [n, rows] feed applied in order, in place on ``table``.

    ``table`` is the fused [N+R, k] float32 table (relation row ids offset by
    ``n_entities``), contiguous; ``batches`` holds ph, pt, r, nh, nt and valid,
    [n, rows] each.  Calling the object with i applies batch i; the batches
    must be applied in order.  ``loss`` [n] holds each applied batch's loss,
    and ``params()`` gives the table's entity and relation rows.
    ``group`` is the rows a positive takes side by side in the feed (the
    negatives a positive, K): the kernel gives each group of rows one warp,
    and is right for any layout.

    CUDA tables go to the kernels, CPU tables to ``plain``; any other device
    raises.  On the card the kernels read the feed where it lies when its
    ids are int32 and ``valid`` bool, contiguous, as the sampler draws them
    (any other feed is converted once), so the caller leaves the feed
    unchanged until the last call; ``acc`` is their accumulator, equal to
    ``table`` between calls.
    """

    def __init__(self, table: torch.Tensor, n_entities: int, batches: Dict[str, torch.Tensor], *,
                 learning_rate: float, margin: float, l1: bool, plain: Plain, group: int = 1):
        dev = table.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"transe_fast: no kernel for device {dev}")
        n_rows, k = table.shape
        n, rows = batches["ph"].shape
        if table.dtype != torch.float32 or not table.is_contiguous():
            raise ValueError(f"transe_fast: the table must be a contiguous float32 tensor, got {table.dtype}")
        if not takes(k, rows) or n_rows >= 2**31 or not 0 < n_entities < n_rows or group < 1:
            raise ValueError(f"transe_fast: k = {k} must lie in [1, {MAX_K}], the table hold entities and "
                             f"relations, a batch's 5 rows·k deltas number under 2^31, and group = {group} be "
                             f"positive")
        for key in (*ID_KEYS, "valid"):
            x = batches[key]
            if x.device != dev or tuple(x.shape) != (n, rows):
                raise ValueError(f"transe_fast: {key} must be of shape {(n, rows)} on {dev}, "
                                 f"got {tuple(x.shape)} on {x.device}")
        self.table, self.n, self.n_entities, self.on_card = table, n, n_entities, dev.type == "cuda"
        self.loss = torch.zeros(n, dtype=torch.float32, device=dev)
        if not self.on_card:
            self.batches, self.plain = batches, plain
            return
        # Everything but the batch's offsets, once: a call only adds them.
        self.batches = {key: batches[key].to(torch.bool if key == "valid" else torch.int32).contiguous()
                        for key in (*ID_KEYS, "valid")}
        self.lib, self.rows = _library(), rows
        self.ids = [self.batches[key].data_ptr() for key in ID_KEYS]
        self.valid, self.losses = self.batches["valid"].data_ptr(), self.loss.data_ptr()
        # The accumulator and a batch's scratch: each row's two directions
        # and whether it steps.
        self.acc = table.clone()
        self.x = torch.empty(rows, 2, k, dtype=torch.float32, device=dev)
        self.step = torch.empty(rows, dtype=torch.uint8, device=dev)
        self.tables = (table.data_ptr(), self.acc.data_ptr(), self.x.data_ptr(), self.step.data_ptr())
        self.tail = (group, k, n_entities, n_rows - n_entities, int(l1), cuda_build.device_index(dev),
                     float(learning_rate), float(margin), torch.cuda.current_stream(dev).cuda_stream)

    def __call__(self, i: int) -> None:
        if not 0 <= i < self.n:
            raise IndexError(f"transe_fast: batch {i} of {self.n}")
        if not self.on_card:
            table, self.loss[i] = self.plain(self.table, {key: v[i] for key, v in self.batches.items()})
            self.table.copy_(table)
            return
        lib, step = self.lib, i * self.rows
        cuda_build.check_launch(lib, lib.kb2e_transe_fast_batch(
            *self.tables, *(p + 4 * step for p in self.ids), self.valid + step, self.losses + 4 * i, self.rows,
            *self.tail), WHAT)
        for name in KERNEL_NAMES:
            cuda_build.launch_counts[name] += 1

    def params(self) -> Dict[str, torch.Tensor]:
        """``table``'s entity and relation rows, as views."""
        return {"entity": self.table[:self.n_entities], "relation": self.table[self.n_entities:]}
