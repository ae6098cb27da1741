"""Reference-exact sequential TransR update (parity mode): a hand-written CUDA kernel.

Counterpart of ``kb2e_tpu/ops/pallas_update.py::transr_sequential_update``
and of the scan path of ``kb2e_tpu/models/transr.py::sequential_update``.
One batch of the reference's hot loop (``transr/trainer.cpp:118-191``,
``common/trainer.cpp:130-149``), one sample at a time in order:

* both energies read the batch-start snapshot (rows and W_r); updates land
  in the output tables, which start as copies of it;
* a sample updates only when it is valid and violates the margin,
  e_pos + margin > e_neg; its loss margin + e_pos − e_neg is added in sample
  order;
* per direction (the positive triple with β = −1, then the corrupted one
  with β = +1), with h, t, W from the snapshot and x = 2·res (L1: +1 where
  2·res > 0, else −1): W_r −= β·lr·outer(h − t, x); with wx = W·x,
  h −= β·lr·wx, t += β·lr·wx, r −= β·lr·x; then sphere-norm r, h, t and every
  row of W_r, and run the exact-sequential ``transRNorm`` projector
  (:func:`transr_ball_project`) on (h, W_r), (t, W_r) and (r, W_r), the last
  being the intent of the reference's bug B2;
* when h == t both deltas land on the one row, which is sphere-normed twice
  and projected twice.

* On a CUDA tensor :func:`transr_sequential_update` launches the kernels of
  ``csrc/transr_update.cu`` (what bounds them and their design are noted
  there), or raises: a decide pass, one block per sample, for the decisions,
  x and the loss; then, with each update's predecessors on its rows from
  :func:`kb2e_tpu_torch.ops.schedule.row_predecessors`, an update pass that
  runs samples side by side across the SMs in the reference's per-row order.
  They are compiled by :mod:`kb2e_tpu_torch.ops.cuda_build` at first use and
  bound with ``ctypes``.
* On a CPU tensor it runs :func:`transr_sequential_update_reference`, the
  plain PyTorch version.  It takes every sum in the kernel's order — over
  the block (:func:`~kb2e_tpu_torch.ops.transh_update.kernel_order_sum`) or
  one thread's running sum (:func:`serial_sum`) — and rounds every step as
  its own torch op, so the kernel and the plain version agree bit for bit,
  whether the plain version runs on the card or on the CPU (its square roots
  go through float64, :func:`sqrt_rn`, since the CPU's vectorised float32
  square root is not correctly rounded).

Each of the wrapper's calls on the card adds one to
``cuda_build.launch_counts``, one a batch (its three launches together);
only the launch path adds to it.
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

KERNEL_NAMES = {Distance.L1: "transr_update_l1", Distance.L2: "transr_update_l2"}
SOURCE = cuda_build.CSRC / "transr_update.cu"
BUILD_DIR = cuda_build.BUILD_DIR
WHAT = "TransR sequential-update"  # names the kernels in launch errors
# One coordinate per thread and the working W_r in shared memory, k × (k | 1)
# floats: 224 keeps it inside the 227 KB a block may have.
MAX_K = 224


def build() -> Path:
    """Compile ``csrc/transr_update.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kb2e_transr_decide.argtypes = [ptr] * 13 + [c_int] * 4 + [c_float, ptr]
    lib.kb2e_transr_apply.argtypes = [ptr] * 15 + [c_int] * 4 + [c_float, ptr]
    lib.kb2e_transr_blocks_per_sm.argtypes = [c_int, c_int, ptr]
    for fn in (lib.kb2e_transr_decide, lib.kb2e_transr_apply, lib.kb2e_transr_blocks_per_sm):
        fn.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def serial_sum(terms) -> torch.Tensor:
    """Σ of ``terms`` in order, starting from 0: one thread's running sum in the kernel."""
    terms = iter(terms)
    first = next(terms)
    acc = torch.zeros_like(first) + first
    for term in terms:
        acc = acc + term
    return acc


def row_times_matrix(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(a·W)_i = Σ_j a_j·W[j, i] over rows a [..., k] and w [..., k, k], j in
    order (the kernel's thread i sums its column)."""
    return serial_sum(a[..., j, None] * w[..., j, :] for j in range(a.shape[-1]))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the kernel's __fsqrt_rn) on
    any device: the float64 root, within an ulp of float64, rounds to it."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _sphere(v: torch.Tensor, sumsq: torch.Tensor) -> torch.Tensor:
    return v / sqrt_rn(sumsq)


def transr_ball_project(a: torch.Tensor, w: torch.Tensor, rate: float, max_iters: int = 16):
    """``transRNorm`` (transr/trainer.cpp:34-64) on the row a [k] and the
    matrix w [k, k] laid out [j, i], as the kernel runs it and as
    ``kb2e_tpu.ops.projections.transr_ball_project(exact_sequential=True)``
    defines it: up to ``max_iters`` trips while ‖a·W‖² > 1, each walking the
    output dims i in order, tmp = 2·W[:, i]·a; W[:, i] −= rate·tmp·a;
    a −= rate·tmp·W[:, i] (the new column), each i reading the ``a`` that the
    previous i changed.  Sums run in the kernel's order.  Returns (a, w,
    fired trips); w is a new tensor."""
    w = w.clone()
    fired = 0
    while fired < max_iters:
        p = row_times_matrix(a, w)
        if not bool(kernel_order_sum(p * p) > 1.0):
            break
        for i in range(a.shape[0]):
            # rate·(2·dot) in one rounding: 2·rate and 2·dot are exact.
            s = (2.0 * rate) * kernel_order_sum(w[:, i] * a)
            col = w[:, i] - s * a
            w[:, i] = col
            a = a - s * col
        fired += 1
    return a, w, fired


def transr_sequential_update_reference(
    entity: torch.Tensor,  # [N, k] batch-start snapshot
    relation: torch.Tensor,  # [R, k]
    proj: torch.Tensor,  # [R, k, k] laid out [j, i]
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
    max_iters: int,
):
    """Plain PyTorch version: (entity', relation', proj', loss, viol, trips).

    The snapshot energies of all samples are taken at once (they read only
    the snapshot); the updates of the violating samples then run one sample
    at a time, in order, on the output tables.  ``trips`` int32 [B, 2]
    counts, per sample over its six projector calls, the fired projector
    trips and the calls that stopped at ``max_iters``.
    """
    snap_e, snap_r, snap_w = (t.to(torch.float32) for t in (entity, relation, proj))
    ent, rel, wt = snap_e.clone(), snap_r.clone(), snap_w.clone()
    w = snap_w[r]
    he, te, nhe, nte = snap_e[ph], snap_e[pt], snap_e[nh], snap_e[nt]
    hp, tp, nhp, ntp = (row_times_matrix(row, w) for row in (he, te, nhe, nte))
    rv = snap_r[r]
    res_p, res_n = (tp - hp) - rv, (ntp - nhp) - rv
    if l1:
        terms = (res_p.abs(), res_n.abs())
        x_p, x_n = (torch.where(2.0 * res > 0, 1.0, -1.0) for res in (res_p, res_n))
    else:
        terms = (res_p * res_p, res_n * res_n)
        x_p, x_n = 2.0 * res_p, 2.0 * res_n
    e_p, e_n = kernel_order_sum(torch.stack(terms))
    viol = (e_p + margin > e_n) & valid.to(torch.bool)
    loss = np.float32(0.0)
    for term in (margin + e_p - e_n)[viol].cpu().numpy():
        loss = np.float32(loss + term)

    lr = learning_rate
    trips = torch.zeros((ph.shape[0], 2), dtype=torch.int32)
    rows = torch.stack([ph, pt, r, nh, nt], 1)[viol].tolist()
    for i, (h, t, rr, hn, tn) in zip(viol.nonzero()[:, 0].tolist(), rows):
        rel_row, w_row, w_snap = rel[rr], wt[rr], snap_w[rr]
        n_trips = [0, 0]

        def ball(a, w):
            a, w, fired = transr_ball_project(a, w, lr, max_iters)
            n_trips[0] += fired
            n_trips[1] += fired == max_iters
            return a, w

        directions = ((h, t, x_p[i], he[i], te[i], -1.0), (hn, tn, x_n[i], nhe[i], nte[i], 1.0))
        for hh, tt, x, h_snap, t_snap, beta in directions:
            alias = hh == tt
            c1, c2 = -beta * lr, beta * lr
            w_row = w_row + c1 * torch.outer(h_snap - t_snap, x)
            wx = serial_sum(w_snap[:, col] * x[col] for col in range(x.shape[0]))
            h_row = ent[hh] + c1 * wx
            if alias:
                h_row = h_row + c2 * wx
            else:
                t_row = ent[tt] + c2 * wx
            rel_row = rel_row + c1 * x
            if alias:
                sq = kernel_order_sum(torch.stack([rel_row * rel_row, h_row * h_row]))
                rel_row, h_row = _sphere(rel_row, sq[0]), _sphere(h_row, sq[1])
                h_row = _sphere(h_row, kernel_order_sum(h_row * h_row))
            else:
                sq = kernel_order_sum(torch.stack([rel_row * rel_row, h_row * h_row, t_row * t_row]))
                rel_row, h_row, t_row = _sphere(rel_row, sq[0]), _sphere(h_row, sq[1]), _sphere(t_row, sq[2])
            row_sq = serial_sum(w_row[:, col] * w_row[:, col] for col in range(w_row.shape[1]))
            w_row = w_row / sqrt_rn(row_sq)[:, None]
            h_row, w_row = ball(h_row, w_row)
            if alias:
                h_row, w_row = ball(h_row, w_row)
            else:
                t_row, w_row = ball(t_row, w_row)
                ent[tt] = t_row
            rel_row, w_row = ball(rel_row, w_row)
            ent[hh] = h_row
        rel[rr], wt[rr] = rel_row, w_row
        trips[i] = torch.tensor(n_trips, dtype=torch.int32)
    return ent, rel, wt, torch.tensor(loss, device=entity.device), viol, trips.to(entity.device)


def transr_sequential_update(
    entity: torch.Tensor,  # [N, k] float32, contiguous: the batch-start snapshot
    relation: torch.Tensor,  # [R, k] float32, contiguous
    proj: torch.Tensor,  # [R, k, k] float32, contiguous, laid out [j, i]
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
    max_iters: int,
):
    """(entity', relation', proj', loss, viol, trips) with the reference's
    sequential semantics.

    CUDA tensors go to the kernel, CPU tensors to the plain version.  The
    snapshot is not written: the outputs are new tables.  ``viol`` is the
    bool [B] per-sample update decision, ``trips`` the int32 [B, 2] count of
    each sample's fired projector trips and of its projector calls that
    stopped at ``max_iters``.
    """
    dev = entity.device
    kw = dict(learning_rate=learning_rate, margin=margin, l1=l1, max_iters=max_iters)
    if dev.type == "cpu":
        return transr_sequential_update_reference(entity, relation, proj, ph, pt, r, nh, nt, valid, **kw)
    if dev.type != "cuda":
        raise ValueError(f"transr_sequential_update: no kernel for device {dev}")
    n, k = entity.shape
    n_rel, b = relation.shape[0], ph.shape[0]
    checks = [(name, x, torch.float32, shape) for name, x, shape in
              (("entity", entity, (n, k)), ("relation", relation, (n_rel, k)), ("proj", proj, (n_rel, k, k)))]
    checks += [(name, x, torch.int32, (b,)) for name, x in zip(("ph", "pt", "r", "nh", "nt"), (ph, pt, r, nh, nt))]
    checks.append(("valid", valid, torch.bool, (b,)))
    for name, x, dtype, shape in checks:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"transr_sequential_update: {name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if not 0 < k <= MAX_K or max(n * k, n_rel * k * k) >= 2**31 or max_iters < 0:
        raise ValueError(
            f"transr_sequential_update: k = {k} must lie in [1, {MAX_K}], N·k and R·k·k below 2^31, "
            f"and max_iters = {max_iters} must not be negative"
        )
    schedule.check_ids("transr_sequential_update", ph, pt, r, nh, nt, n, n_rel)

    ent_out, rel_out, proj_out = entity.clone(), relation.clone(), proj.clone()
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    viol = torch.empty(b, dtype=torch.int32, device=dev)
    trips = torch.empty((b, 2), dtype=torch.int32, device=dev)
    xs = torch.empty((b, 2, k), dtype=torch.float32, device=dev)  # each sample's x_p and x_n
    terms = torch.empty(b, dtype=torch.float32, device=dev)  # each sample's margin + e_p − e_n
    order = torch.zeros(b + 1, dtype=torch.int32, device=dev)  # the done flags, then the ticket
    lib = _library()
    index = cuda_build.device_index(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check_launch(lib, lib.kb2e_transr_decide(
        entity.data_ptr(), relation.data_ptr(), proj.data_ptr(),
        ph.data_ptr(), pt.data_ptr(), r.data_ptr(), nh.data_ptr(), nt.data_ptr(), valid.data_ptr(),
        xs.data_ptr(), terms.data_ptr(), viol.data_ptr(), loss.data_ptr(),
        k, b, int(l1), index, float(margin), stream,
    ), WHAT)
    decided = viol.to(torch.bool)
    pred = schedule.row_predecessors(schedule.update_rows(ph, pt, nh, nt, r, n), decided)
    cuda_build.check_launch(lib, lib.kb2e_transr_apply(
        entity.data_ptr(), proj.data_ptr(), ent_out.data_ptr(), rel_out.data_ptr(), proj_out.data_ptr(),
        ph.data_ptr(), pt.data_ptr(), r.data_ptr(), nh.data_ptr(), nt.data_ptr(),
        viol.data_ptr(), xs.data_ptr(), pred.data_ptr(), order.data_ptr(), trips.data_ptr(),
        k, b, max_iters, index, float(learning_rate), stream,
    ), WHAT)
    cuda_build.launch_counts[KERNEL_NAMES[Distance.L1 if l1 else Distance.L2]] += 1
    return ent_out, rel_out, proj_out, loss, decided, trips


def resident_blocks_per_sm(k: int, device: torch.device | None = None) -> int:
    """Blocks of the update pass that fit on one SM of ``device`` at once, at width k."""
    lib = _library()
    return cuda_build.blocks_per_sm(lib, lib.kb2e_transr_blocks_per_sm, k, device, WHAT)
