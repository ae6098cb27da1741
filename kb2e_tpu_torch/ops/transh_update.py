"""Reference-exact sequential TransH update (parity mode): a hand-written CUDA kernel.

Counterpart of ``kb2e_tpu/ops/pallas_update.py::transh_sequential_update``
and of the scan path of ``kb2e_tpu/models/transh.py::sequential_update``.
One batch of the reference's hot loop (``transh/trainer.cpp:11-58``,
``common/trainer.cpp:130-149``), one sample at a time in order:

* both energies read the batch-start snapshot (the reference's double
  buffer); updates land in the output tables, which start as copies of it;
* a sample updates only when it is valid and violates the margin,
  e_pos + margin > e_neg; its loss margin + e_pos − e_neg is added in sample
  order;
* per direction (the positive triple with β = −1, then the corrupted one
  with β = +1), with x, hs = w·h, ts = w·t, h and t from the snapshot:
  r, h += −β·lr·x; t += β·lr·x; w += β·lr·(x·(hs − ts) + sum_x·(h − t));
  then ball-norm r, h, t, sphere-norm w, and run the orthogonality projector
  (``ops/projections.py::orthogonality_project``) on (r, w), (h, w), (t, w);
* when h == t both deltas land on the one row, which is ball-normed twice
  (the second norm reading the first's result) and projected twice.

* On a CUDA tensor :func:`transh_sequential_update` launches the kernel of
  ``csrc/transh_update.cu`` (what bounds it and its design are noted there),
  or raises.  It is compiled by :mod:`kb2e_tpu_torch.ops.cuda_build` at
  first use and bound with ``ctypes``.
* On a CPU tensor it runs :func:`transh_sequential_update_reference`, the
  plain PyTorch version.  It takes every sum over k in the kernel's order
  (:func:`kernel_order_sum`) and rounds every elementwise step as its own
  torch op, so on the card the kernel and the plain version agree bit for bit.

``launch_counts`` counts the kernel's launches; only the launch path adds to it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from kb2e_tpu_torch.ops import cuda_build

KERNEL_NAME = "transh_update"
SOURCE = cuda_build.CSRC / "transh_update.cu"
BUILD_DIR = cuda_build.BUILD_DIR
MAX_K = 1024  # one coordinate per thread, one block
WARP = 32

# Kernel launches by kernel name, added to only where a kernel is launched.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def build() -> Path:
    """Compile ``csrc/transh_update.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kb2e_transh_update.argtypes = [ptr] * 15 + [c_int] * 4 + [c_float] * 2 + [ptr]
    lib.kb2e_transh_update.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in the kernel's block-reduction order.

    Coordinate c sits in lane c % 32 of warp c // 32 (k padded with zeros to
    whole warps); each warp halves by 16, 8, 4, 2, 1 (lane i adds lane
    i + off), then the warps' sums are added in order.
    """
    k = x.shape[-1]
    n_warps = -(-k // WARP)
    x = torch.nn.functional.pad(x, (0, n_warps * WARP - k)).reshape(*x.shape[:-1], n_warps, WARP)
    off = WARP // 2
    while off:
        x = x[..., :off] + x[..., off : 2 * off]
        off //= 2
    x = x[..., 0]
    total = x[..., 0]
    for w in range(1, n_warps):
        total = total + x[..., w]
    return total


def _ball(v: torch.Tensor, sumsq: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(sumsq)
    return torch.where(n > 1.0, v / n, v)


def _sphere(v: torch.Tensor, sumsq: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(sumsq)


def _project(a: torch.Tensor, b: torch.Tensor, lr: float, max_iters: int, trips: list):
    """The orthogonality projector on one (a, b) row pair, as the kernel runs
    it; returns (a, b) and adds its fired trips to ``trips[0]`` and 1 to
    ``trips[1]`` if it stopped at ``max_iters``."""
    b = _sphere(b, kernel_order_sum(b * b))
    s = torch.zeros((), dtype=b.dtype, device=b.device)
    fired = 0
    while fired < max_iters:
        root = torch.sqrt(s + kernel_order_sum(b * b))
        b_scaled = b / root
        if not bool(kernel_order_sum(b_scaled * a) > 0.1):
            b = b_scaled
            break
        a = a - lr * b_scaled
        b = b_scaled - lr * a
        s = root
        fired += 1
    trips[0] += fired
    trips[1] += fired == max_iters
    return a, _sphere(b, kernel_order_sum(b * b))


def transh_sequential_update_reference(
    entity: torch.Tensor,  # [N, k] batch-start snapshot
    relation: torch.Tensor,  # [R, k]
    norm: torch.Tensor,  # [R, k] hyperplane normals
    ph: torch.Tensor,  # int [B]
    pt: torch.Tensor,
    r: torch.Tensor,
    nh: torch.Tensor,
    nt: torch.Tensor,
    valid: torch.Tensor,  # bool [B]
    *,
    learning_rate: float,
    margin: float,
    max_iters: int,
):
    """Plain PyTorch version: (entity', relation', norm', loss, viol, trips).

    The snapshot energies of all samples are taken at once (they read only
    the snapshot); the updates of the violating samples then run one sample
    at a time, in order, on the output tables.  ``trips`` int32 [B, 2]
    counts, per sample over its six projector calls, the fired projector
    trips and the calls that stopped at ``max_iters``.
    """
    snap_e, snap_r, snap_w = (t.to(torch.float32) for t in (entity, relation, norm))
    ent, rel, nrm = snap_e.clone(), snap_r.clone(), snap_w.clone()
    he, te, rv, w, nhe, nte = snap_e[ph], snap_e[pt], snap_r[r], snap_w[r], snap_e[nh], snap_e[nt]
    hs_p, ts_p, hs_n, ts_n = kernel_order_sum(torch.stack([w * he, w * te, w * nhe, w * nte]))

    def residual(h_row, t_row, hs, ts):
        return ((t_row - ts[:, None] * w) - (h_row - hs[:, None] * w)) - rv

    res_p, res_n = residual(he, te, hs_p, ts_p), residual(nhe, nte, hs_n, ts_n)
    x_p = torch.where(2.0 * res_p > 0, 1.0, -1.0)
    x_n = torch.where(2.0 * res_n > 0, 1.0, -1.0)
    e_p, e_n, sx_p, sx_n = kernel_order_sum(torch.stack([res_p.abs(), res_n.abs(), x_p * w, x_n * w]))
    viol = (e_p + margin > e_n) & valid.to(torch.bool)
    terms = (margin + e_p - e_n)[viol].cpu().numpy()
    loss = np.float32(0.0)
    for term in terms:
        loss = np.float32(loss + term)

    lr = learning_rate
    trips = torch.zeros((ph.shape[0], 2), dtype=torch.int32)
    rows = torch.stack([ph, pt, r, nh, nt], 1)[viol].tolist()
    for i, (h, t, rr, hn, tn) in zip(viol.nonzero()[:, 0].tolist(), rows):
        rel_row, w_row = rel[rr], nrm[rr]
        n_trips = [0, 0]
        directions = (
            (h, t, x_p[i], sx_p[i], hs_p[i], ts_p[i], he[i], te[i], -1.0),
            (hn, tn, x_n[i], sx_n[i], hs_n[i], ts_n[i], nhe[i], nte[i], 1.0),
        )
        for hh, tt, x, sx, hs, ts, h_snap, t_snap, beta in directions:
            alias = hh == tt
            h_row = ent[hh]
            d, d_t = (-beta * lr) * x, (beta * lr) * x
            rel_row = rel_row + d
            h_row = h_row + d
            if alias:
                h_row = h_row + d_t
            else:
                t_row = ent[tt] + d_t
            w_row = w_row + (beta * lr) * (x * (hs - ts) + sx * (h_snap - t_snap))
            if alias:
                sq = kernel_order_sum(torch.stack([rel_row * rel_row, h_row * h_row, w_row * w_row]))
                rel_row, h_row, w_row = _ball(rel_row, sq[0]), _ball(h_row, sq[1]), _sphere(w_row, sq[2])
                h_row = _ball(h_row, kernel_order_sum(h_row * h_row))
            else:
                sq = kernel_order_sum(torch.stack([rel_row * rel_row, h_row * h_row, t_row * t_row, w_row * w_row]))
                rel_row, h_row, t_row = _ball(rel_row, sq[0]), _ball(h_row, sq[1]), _ball(t_row, sq[2])
                w_row = _sphere(w_row, sq[3])
            rel_row, w_row = _project(rel_row, w_row, lr, max_iters, n_trips)
            h_row, w_row = _project(h_row, w_row, lr, max_iters, n_trips)
            if alias:
                h_row, w_row = _project(h_row, w_row, lr, max_iters, n_trips)
            else:
                t_row, w_row = _project(t_row, w_row, lr, max_iters, n_trips)
                ent[tt] = t_row
            ent[hh] = h_row
        rel[rr], nrm[rr] = rel_row, w_row
        trips[i] = torch.tensor(n_trips, dtype=torch.int32)
    return ent, rel, nrm, torch.tensor(loss, device=entity.device), viol, trips.to(entity.device)


def transh_sequential_update(
    entity: torch.Tensor,  # [N, k] float32, contiguous: the batch-start snapshot
    relation: torch.Tensor,  # [R, k] float32, contiguous
    norm: torch.Tensor,  # [R, k] float32, contiguous
    ph: torch.Tensor,  # int32 [B]
    pt: torch.Tensor,
    r: torch.Tensor,
    nh: torch.Tensor,
    nt: torch.Tensor,
    valid: torch.Tensor,  # bool [B]
    *,
    learning_rate: float,
    margin: float,
    max_iters: int,
):
    """(entity', relation', norm', loss, viol, trips) with the reference's
    sequential semantics.

    CUDA tensors go to the kernel, CPU tensors to the plain version.  The
    snapshot is not written: the outputs are new tables.  ``viol`` is the
    bool [B] per-sample update decision, ``trips`` the int32 [B, 2] count of
    each sample's fired projector trips and of its projector calls that
    stopped at ``max_iters``.
    """
    dev = entity.device
    if dev.type == "cpu":
        return transh_sequential_update_reference(
            entity, relation, norm, ph, pt, r, nh, nt, valid,
            learning_rate=learning_rate, margin=margin, max_iters=max_iters,
        )
    if dev.type != "cuda":
        raise ValueError(f"transh_sequential_update: no kernel for device {dev}")
    n, k = entity.shape
    n_rel, b = relation.shape[0], ph.shape[0]
    checks = [(name, x, torch.float32, shape) for name, x, shape in
              (("entity", entity, (n, k)), ("relation", relation, (n_rel, k)), ("norm", norm, (n_rel, k)))]
    checks += [(name, x, torch.int32, (b,)) for name, x in zip(("ph", "pt", "r", "nh", "nt"), (ph, pt, r, nh, nt))]
    checks.append(("valid", valid, torch.bool, (b,)))
    for name, x, dtype, shape in checks:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"transh_sequential_update: {name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if not 0 < k <= MAX_K or max(n, n_rel) * k >= 2**31 or max_iters < 0:
        raise ValueError(
            f"transh_sequential_update: k = {k} must lie in [1, {MAX_K}], N·k and R·k below 2^31, "
            f"and max_iters = {max_iters} must not be negative"
        )
    if b:
        # Out-of-range rows would be read and written outside the tables.
        ids = torch.stack([ph, pt, nh, nt])
        lo, hi, rlo, rhi = torch.stack([ids.min(), ids.max(), r.min(), r.max()]).tolist()
        if lo < 0 or hi >= n or rlo < 0 or rhi >= n_rel:
            raise ValueError(
                f"transh_sequential_update: entity ids in [{lo}, {hi}] or relation ids in [{rlo}, {rhi}] "
                f"fall outside [0, {n}) / [0, {n_rel})"
            )

    ent_out, rel_out, norm_out = entity.clone(), relation.clone(), norm.clone()
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    viol = torch.empty(b, dtype=torch.int32, device=dev)
    trips = torch.empty((b, 2), dtype=torch.int32, device=dev)
    lib = _library()
    code = lib.kb2e_transh_update(
        entity.data_ptr(), relation.data_ptr(), norm.data_ptr(),
        ent_out.data_ptr(), rel_out.data_ptr(), norm_out.data_ptr(),
        ph.data_ptr(), pt.data_ptr(), r.data_ptr(), nh.data_ptr(), nt.data_ptr(), valid.data_ptr(),
        loss.data_ptr(), viol.data_ptr(), trips.data_ptr(),
        k, b, max_iters, dev.index if dev.index is not None else torch.cuda.current_device(),
        float(learning_rate), float(margin), torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"TransH sequential-update kernel launch failed: {lib.kb2e_cuda_error_string(code).decode()} "
            f"(cuda error {code})"
        )
    launch_counts[KERNEL_NAME] += 1
    return ent_out, rel_out, norm_out, loss, viol.to(torch.bool), trips
