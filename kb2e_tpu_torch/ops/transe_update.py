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

* On a CUDA tensor :func:`transe_sequential_update` launches the kernel of
  ``csrc/transe_update.cu`` (L1 and L2 templates; what bounds it and its
  design are noted there), or raises.  It is compiled by
  :mod:`kb2e_tpu_torch.ops.cuda_build` at first use and bound with ``ctypes``.
* On a CPU tensor it runs :func:`transe_sequential_update_reference`, the
  plain PyTorch version: the per-sample loop of the JAX scan path.

``launch_counts`` counts the kernel's launches per distance; only the launch
path adds to it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from kb2e_tpu_torch.constants import Distance
from kb2e_tpu_torch.ops import cuda_build, projections

KERNEL_NAMES = {Distance.L1: "transe_update_l1", Distance.L2: "transe_update_l2"}
SOURCE = cuda_build.CSRC / "transe_update.cu"
BUILD_DIR = cuda_build.BUILD_DIR
MAX_K = 1024  # one coordinate per thread, one block

# Kernel launches by kernel name, added to only where a kernel is launched.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def build() -> Path:
    """Compile ``csrc/transe_update.cu`` into ``BUILD_DIR`` unless it is built already."""
    return cuda_build.build(SOURCE, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kb2e_transe_update.argtypes = [ptr] * 12 + [c_int] * 4 + [c_float] * 2 + [ptr]
    lib.kb2e_transe_update.restype = c_int
    lib.kb2e_cuda_error_string.argtypes = [c_int]
    lib.kb2e_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ball(row: torch.Tensor) -> torch.Tensor:
    return projections.ball_norm(row[None, :])[0]


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
    samples' margin + e_pos − e_neg in sample order, in float32.
    """
    snap_e, snap_r = entity.to(torch.float32), relation.to(torch.float32)
    ent, rel = snap_e.clone(), snap_r.clone()
    rv = snap_r[r]
    res_p = snap_e[pt] - snap_e[ph] - rv
    res_n = snap_e[nt] - snap_e[nh] - rv
    if l1:
        e_p, e_n = res_p.abs().sum(-1), res_n.abs().sum(-1)
        x_p, x_n = torch.where(2.0 * res_p > 0, 1.0, -1.0), torch.where(2.0 * res_n > 0, 1.0, -1.0)
    else:
        e_p, e_n = (res_p * res_p).sum(-1), (res_n * res_n).sum(-1)
        x_p, x_n = 2.0 * res_p, 2.0 * res_n
    viol = (e_p + margin > e_n) & valid.to(torch.bool)
    terms = (margin + e_p - e_n)[viol].cpu().numpy()
    loss = np.float32(0.0)
    for term in terms:
        loss = np.float32(loss + term)

    lr = learning_rate
    idx = torch.stack([ph, pt, r, nh, nt], 1)[viol].tolist()
    for b, (h, t, rr, hn, tn) in zip(viol.nonzero()[:, 0].tolist(), idx):
        for (hh, tt), x, s in (((h, t), x_p[b], lr), ((hn, tn), x_n[b], -lr)):
            # s = −β·lr: r, h += s·x; t −= s·x (t after h, so h == t sums
            # both deltas on one row), then ball-norm r, h, t in that order.
            rel[rr] += s * x
            ent[hh] += s * x
            ent[tt] += -s * x
            rel[rr] = _ball(rel[rr])
            ent[hh] = _ball(ent[hh])
            ent[tt] = _ball(ent[tt])
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

    CUDA tensors go to the kernel, CPU tensors to the plain version.  The
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
    if b:
        # Out-of-range rows would be read and written outside the tables.
        ids = torch.stack([ph, pt, nh, nt])
        lo, hi, rlo, rhi = torch.stack([ids.min(), ids.max(), r.min(), r.max()]).tolist()
        if lo < 0 or hi >= n or rlo < 0 or rhi >= n_rel:
            raise ValueError(
                f"transe_sequential_update: entity ids in [{lo}, {hi}] or relation ids in [{rlo}, {rhi}] "
                f"fall outside [0, {n}) / [0, {n_rel})"
            )

    ent_out, rel_out = entity.clone(), relation.clone()
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    viol = torch.empty(b, dtype=torch.int32, device=dev)
    distance = Distance.L1 if l1 else Distance.L2
    lib = _library()
    code = lib.kb2e_transe_update(
        entity.data_ptr(), relation.data_ptr(), ent_out.data_ptr(), rel_out.data_ptr(),
        ph.data_ptr(), pt.data_ptr(), r.data_ptr(), nh.data_ptr(), nt.data_ptr(), valid.data_ptr(),
        loss.data_ptr(), viol.data_ptr(),
        k, b, int(l1), dev.index if dev.index is not None else torch.cuda.current_device(),
        float(learning_rate), float(margin), torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"sequential-update kernel launch failed: {lib.kb2e_cuda_error_string(code).decode()} (cuda error {code})"
        )
    launch_counts[KERNEL_NAMES[distance]] += 1
    return ent_out, rel_out, loss, viol.to(torch.bool)
