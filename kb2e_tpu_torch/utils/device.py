"""Device selection for the port's entry points.

Entry points default to ``cuda``.  Without a card that default is an error,
never a quiet move to the CPU: a caller who wants the CPU says so
(``device="cpu"``, CLI ``--device cpu``).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available on this machine; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
