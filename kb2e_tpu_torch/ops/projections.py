"""Constraint-projection operators (counterpart of ``kb2e_tpu/ops/projections.py``).

* :func:`ball_norm` — ``norm(a, ignoreShort=true)`` (common/utils.cpp:70-77):
  project onto the unit *ball* — divide by the length only when length > 1.
* :func:`sphere_norm` — ``norm(a, false)``: project onto the unit *sphere* —
  always divide by the length.
* :func:`orthogonality_project` — ``norm(a, b, rate)``
  (common/utils.cpp:79-111): TransH's coupled gradient loop driving a·b̂
  below 0.1, with the reference's non-reset ``sum`` accumulator, bounded by
  ``max_iters`` trips.  Batched over leading rows, where the JAX package
  vmaps its single-pair version.

TransR's ``transRNorm`` is ``ops/transr_update.py::transr_ball_project``,
in its kernel's sum order; the fast update runs one masked trip of it
inline (``models/transr.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from kb2e_tpu_torch.utils import profiling


def row_norms(x: torch.Tensor, dim: int = -1, keepdim: bool = True) -> torch.Tensor:
    # Accumulate in float32 even for low-precision tables (bf16 squares lose
    # half the mantissa); a float32 input passes through unchanged.
    x32 = x.to(torch.float32)
    return torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=keepdim))


def ball_norm(x: torch.Tensor) -> torch.Tensor:
    """Unit-ball projection per row: divide by ‖x‖ only if ‖x‖ > 1.

    Reference ``norm(a)`` default path, common/utils.cpp:70-77.  Idempotent.
    """
    n = row_norms(x)
    return torch.where(n > 1.0, (x.to(torch.float32) / n).to(x.dtype), x)


def sphere_norm(x: torch.Tensor) -> torch.Tensor:
    """Unit-sphere projection per row: always divide by ‖x‖.

    Reference ``norm(a, false)``.  Rows of length zero would produce inf in
    the reference too; initialisation makes them measure-zero.
    """
    return (x.to(torch.float32) / row_norms(x)).to(x.dtype)


def orthogonality_project(
    a: torch.Tensor, b: torch.Tensor, rate: float, max_iters: int = 16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TransH orthogonality projector on rows [..., k], per row as
    common/utils.cpp:79-111 and ``kb2e_tpu.ops.projections.orthogonality_project``.

    Each row: b ← b/‖b‖; then up to ``max_iters`` trips, each taking
    s ← √(s + Σb²) (s starts at 0 and is never reset) and b̂ = b/s and
    testing b̂·a > 0.1.  A trip that fires sets a ← a − rate·b̂, then
    b ← b̂ − rate·a with the new a; a trip that does not fire sets b ← b̂ and
    freezes the row.  A row that reaches ``max_iters`` keeps its last fired b.
    Finally b ← b/‖b‖.

    Rows run together under masks.  The loop leaves early when no row is
    active, which costs one host sync a trip; most rows converge at the first
    check, so that is cheaper than ``max_iters`` masked trips.

    While a profiler records (``utils/profiling.py``) a call adds 1 to the
    counter ``transh.project_calls``, its trips (one host sync each) to
    ``transh.project_syncs``, and on the device the rows still firing when
    the cap stops the loop to ``transh.project_capped``.
    """
    b = sphere_norm(b)
    s = torch.zeros(b.shape[:-1] + (1,), dtype=b.dtype, device=b.device)
    active = torch.ones_like(s, dtype=torch.bool)
    trips = 0
    for _ in range(max_iters):
        s_new = torch.sqrt(s + torch.sum(b * b, dim=-1, keepdim=True))
        b_scaled = b / s_new
        fire = torch.sum(b_scaled * a, dim=-1, keepdim=True) > 0.1
        a_next = a - rate * b_scaled
        b_next = torch.where(fire, b_scaled - rate * a_next, b_scaled)
        a = torch.where(active & fire, a_next, a)
        b = torch.where(active, b_next, b)
        s = torch.where(active, s_new, s)
        active = active & fire
        trips += 1
        if not bool(active.any()):
            break
    profiling.count("transh.project_calls", 1)
    profiling.count("transh.project_syncs", trips)
    if profiling.recording():
        profiling.count_device("transh.project_capped", active.sum())
    return a, sphere_norm(b)
