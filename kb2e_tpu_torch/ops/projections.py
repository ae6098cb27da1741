"""Constraint-projection operators (counterpart of ``kb2e_tpu/ops/projections.py``).

* :func:`ball_norm` — ``norm(a, ignoreShort=true)`` (common/utils.cpp:70-77):
  project onto the unit *ball* — divide by the length only when length > 1.

The sphere, orthogonality and TransR projections come with the models that
use them.
"""

from __future__ import annotations

import torch


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
