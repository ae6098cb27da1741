"""Mid-training checkpoints and resume.

Counterpart of ``kb2e_tpu/io/checkpoint.py``, with ``torch.save`` /
``torch.load`` in place of Orbax.  A checkpoint is one file holding the
params (on the CPU), the step (epochs done) and any extra state the trainer
passes — the training loop passes its generator's state, so a resumed run
draws what the uninterrupted run would have drawn.  The text format
(:mod:`kb2e_tpu_torch.io.text`) stays the interop format with the reference
binaries.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def save(path: str, params: Dict[str, torch.Tensor], step: int = 0, extra: Optional[dict] = None) -> None:
    """Save params and the step (+ ``extra``) to the file ``path``, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "meta": {"step": int(step), **(extra or {})},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore(path: str) -> Tuple[Dict[str, torch.Tensor], int, Dict[str, Any]]:
    """Load a checkpoint saved by :func:`save`; returns (params, step, meta)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = payload["meta"]
    return payload["params"], int(meta["step"]), meta


def latest_in(dir_path: str, prefix: str = "ckpt_") -> Optional[str]:
    """The checkpoint under ``dir_path`` with the highest step suffix."""
    if not os.path.isdir(dir_path):
        return None
    best, best_step = None, -1
    for name in os.listdir(dir_path):
        if name.startswith(prefix):
            try:
                step = int(name[len(prefix):])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(dir_path, name), step
    return best
