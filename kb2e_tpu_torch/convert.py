"""Parameter dictionaries between numpy arrays and torch tensors.

The text-format readers and writers, and the tests that hand ``kb2e_tpu``'s
parameters to this package, work in numpy; the models work in tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Copy each array to a tensor of the same dtype on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy each tensor back to a host numpy array of the same dtype."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
