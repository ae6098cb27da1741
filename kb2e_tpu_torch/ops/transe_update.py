"""Reference-exact sequential TransE update (parity mode): a hand-written CUDA kernel.

Counterpart of ``kb2e_tpu/ops/pallas_update.py::transe_sequential_update``
and of the scan path of ``kb2e_tpu/models/transe.py::sequential_update``.
One batch of the reference's hot loop (``transe/trainer.cpp:25-56``,
``common/trainer.cpp:130-149``), one sample at a time in order:

* both energies read the batch-start snapshot (the reference's double
  buffer); updates land in the output tables, which start as copies of it;
* a sample updates only when it violates the margin, e_pos + margin > e_neg,
  and is valid; its loss margin + e_pos − e_neg is added in sample order;
* the positive triple first (r, h += lr·x; t −= lr·x, then ball-norm r, h
  and t in that order), then the corrupted one (r, h −= lr·x; t += lr·x,
  ball-norm again), each x from the snapshot residual;
* when h == t both deltas land on the one row before any norm, which is then
  ball-normed twice, the second norm reading the first's result; the
  corrupted triple sees the rows the positive one wrote.

* On a CUDA tensor :func:`transe_sequential_update` launches the kernels of
  ``csrc/transe_update.cu`` (L1 and L2 templates of the decide pass; what
  bounds them and their design are noted there), or raises: a decide pass,
  one block per sample, for the decisions and the loss; then, with each
  update's predecessors on its rows from
  :func:`kb2e_tpu_torch.ops.schedule.row_predecessors`, an update pass that
  runs samples side by side across the SMs in the reference's per-row order.
  They are compiled by :mod:`kb2e_tpu_torch.ops.cuda_build` at first use and
  bound with ``ctypes``.
* On a CPU tensor it runs :func:`transe_sequential_update_reference`, the
  plain PyTorch version.  It takes every sum over k in the kernel's order
  (``kernel_order_sum``), square roots correctly rounded (``sqrt_rn``), and
  rounds every elementwise step as its own torch op, so on the card the
  kernel and the plain version agree bit for bit.

Each of the wrapper's calls on the card adds one to
``cuda_build.launch_counts``, one a batch (its three launches together), per
distance; only the launch path adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import cuda_build, schedule
from kb2e_tpu_torch.ops.transh_update import kernel_order_sum
from kb2e_tpu_torch.ops.transr_update import sqrt_rn

KERNEL_NAMES = {Distance.L1: "transe_update_l1", Distance.L2: "transe_update_l2"}
SOURCE = cuda_build.CSRC / "transe_update.cu"
BUILD_DIR = cuda_build.BUILD_DIR
WHAT = "TransE sequential-update"  # names the kernels in launch errors
MAX_K = 1024  # one coordinate per thread, one block a sample


def build() -> Path:
    """Compile ``csrc/transe_update.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kb2e_transe_decide.argtypes = [ptr] * 11 + [c_int] * 4 + [c_float, ptr]
    lib.kb2e_transe_apply.argtypes = [ptr] * 12 + [c_int] * 4 + [c_float, ptr]
    lib.kb2e_transe_blocks_per_sm.argtypes = [c_int, c_int, ptr]
    for fn in (lib.kb2e_transe_decide, lib.kb2e_transe_apply, lib.kb2e_transe_blocks_per_sm):
        fn.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ball(rows: torch.Tensor) -> torch.Tensor:
    """The kernel's ball norm of each row (the last axis): the row over its
    norm where the norm, summed in the kernel's order and rooted correctly
    rounded, exceeds 1."""
    n = sqrt_rn(kernel_order_sum(rows * rows))[..., None]
    return torch.where(n > 1.0, rows / n, rows)


def transe_sequential_update_reference(
    entity: torch.Tensor,  # [N, k] batch-start snapshot
    relation: torch.Tensor,  # [R, k]
    ph: torch.Tensor,  # int [B]
    pt: torch.Tensor,
    r: torch.Tensor,
    nh: torch.Tensor,
    nt: torch.Tensor,
    valid: torch.Tensor,  # bool [B]
    *,
    learning_rate: float,
    margin: float,
    l1: bool,
):
    """Plain PyTorch version: (entity', relation', loss, viol) in float32.

    The snapshot energies of all samples are taken at once (they read only
    the snapshot); the updates of the violating samples then run one sample
    at a time, in order, on the output tables.  The loss adds the violating
    samples' margin + e_pos − e_neg in sample order, in float32.  Every sum
    over k runs in the kernel's order and every step rounds as the kernel's:
    (t − h) − r, d = s·x, r + d, h + d, t + (−d).
    """
    snap_e, snap_r = entity.to(torch.float32), relation.to(torch.float32)
    ent, rel = snap_e.clone(), snap_r.clone()
    rv = snap_r[r]
    res_p = (snap_e[pt] - snap_e[ph]) - rv
    res_n = (snap_e[nt] - snap_e[nh]) - rv
    if l1:
        e_p, e_n = kernel_order_sum(torch.stack([res_p.abs(), res_n.abs()]))
        x_p, x_n = torch.where(2.0 * res_p > 0, 1.0, -1.0), torch.where(2.0 * res_n > 0, 1.0, -1.0)
    else:
        e_p, e_n = kernel_order_sum(torch.stack([res_p * res_p, res_n * res_n]))
        x_p, x_n = 2.0 * res_p, 2.0 * res_n
    viol = (e_p + margin > e_n) & valid.to(torch.bool)
    terms = ((margin + e_p) - e_n)[viol].cpu().numpy()
    loss = np.float32(0.0)
    for term in terms:
        loss = np.float32(loss + term)

    lr = learning_rate
    idx = torch.stack([ph, pt, r, nh, nt], 1)[viol].tolist()
    for i, (h, t, rr, hn, tn) in zip(viol.nonzero()[:, 0].tolist(), idx):
        rel_row = rel[rr]
        for hh, tt, x, s in ((h, t, x_p[i], lr), (hn, tn, x_n[i], -lr)):
            # s = −β·lr: r, h += s·x; t −= s·x (t after h, so h == t sums
            # both deltas on one row), then ball-norm r, h, t in that order;
            # a row h == t is normed twice.
            d = s * x
            rel_row = rel_row + d
            h_row = ent[hh] + d
            if hh == tt:
                rel_row, h_row = _ball(torch.stack([rel_row, h_row + (-d)]))
                ent[hh] = _ball(h_row)
            else:
                rel_row, ent[hh], ent[tt] = _ball(torch.stack([rel_row, h_row, ent[tt] + (-d)]))
        rel[rr] = rel_row
    return ent, rel, torch.tensor(loss, device=entity.device), viol


def transe_sequential_update(
    entity: torch.Tensor,  # [N, k] float32, contiguous: the batch-start snapshot
    relation: torch.Tensor,  # [R, k] float32, contiguous
    ph: torch.Tensor,  # int32 [B]
    pt: torch.Tensor,
    r: torch.Tensor,
    nh: torch.Tensor,
    nt: torch.Tensor,
    valid: torch.Tensor,  # bool [B]
    *,
    learning_rate: float,
    margin: float,
    l1: bool,
):
    """(entity', relation', loss, viol) with the reference's sequential semantics.

    CUDA tensors go to the kernels, CPU tensors to the plain version.  The
    snapshot is not written: the outputs are new tables.  ``viol`` is the
    bool [B] per-sample update decision.
    """
    dev = entity.device
    if dev.type == "cpu":
        return transe_sequential_update_reference(
            entity, relation, ph, pt, r, nh, nt, valid, learning_rate=learning_rate, margin=margin, l1=l1
        )
    if dev.type != "cuda":
        raise ValueError(f"transe_sequential_update: no kernel for device {dev}")
    n, k = entity.shape
    n_rel, b = relation.shape[0], ph.shape[0]
    checks = [("entity", entity, torch.float32, (n, k)), ("relation", relation, torch.float32, (n_rel, k))]
    checks += [(name, x, torch.int32, (b,)) for name, x in zip(("ph", "pt", "r", "nh", "nt"), (ph, pt, r, nh, nt))]
    checks.append(("valid", valid, torch.bool, (b,)))
    for name, x, dtype, shape in checks:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"transe_sequential_update: {name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if not 0 < k <= MAX_K or max(n, n_rel) * k >= 2**31:
        raise ValueError(f"transe_sequential_update: k = {k} must lie in [1, {MAX_K}] and N·k, R·k below 2^31")
    schedule.check_ids("transe_sequential_update", ph, pt, r, nh, nt, n, n_rel)

    ent_out, rel_out = entity.clone(), relation.clone()
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    viol = torch.empty(b, dtype=torch.int32, device=dev)
    terms = torch.empty(b, dtype=torch.float32, device=dev)  # each sample's margin + e_p − e_n
    order = torch.zeros(b + 1, dtype=torch.int32, device=dev)  # the done flags, then the ticket
    lib = _library()
    index = cuda_build.device_index(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check_launch(lib, lib.kb2e_transe_decide(
        entity.data_ptr(), relation.data_ptr(),
        ph.data_ptr(), pt.data_ptr(), r.data_ptr(), nh.data_ptr(), nt.data_ptr(), valid.data_ptr(),
        terms.data_ptr(), viol.data_ptr(), loss.data_ptr(),
        k, b, int(l1), index, float(margin), stream,
    ), WHAT)
    decided = viol.to(torch.bool)
    pred = schedule.row_predecessors(schedule.update_rows(ph, pt, nh, nt, r, n), decided)
    cuda_build.check_launch(lib, lib.kb2e_transe_apply(
        entity.data_ptr(), relation.data_ptr(), ent_out.data_ptr(), rel_out.data_ptr(),
        ph.data_ptr(), pt.data_ptr(), r.data_ptr(), nh.data_ptr(), nt.data_ptr(),
        viol.data_ptr(), pred.data_ptr(), order.data_ptr(),
        k, b, int(l1), index, float(learning_rate), stream,
    ), WHAT)
    cuda_build.launch_counts[KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]] += 1
    return ent_out, rel_out, loss, decided


def resident_blocks_per_sm(k: int, device: torch.device | None = None) -> int:
    """Blocks of the update pass that fit on one SM of ``device`` at once, at width k."""
    lib = _library()
    return cuda_build.blocks_per_sm(lib, lib.kb2e_transe_blocks_per_sm, k, device, WHAT)
