"""Plain PyTorch pieces the models' references share.

The reference C++ tools' definitions (KB2E, ``common/utils.cpp``,
``transe/transe.cpp``): L1 energy Σ|res| and L2 energy Σres² (no root); the
update direction x = 2·res, which L1 maps to +1 where positive and −1
elsewhere, zero included; the ball norm (divide by the length only where it
exceeds 1) and the sphere norm (always divide); and the truncated normal the
tables start from.  Everything is float32 and, where a matrix product is
taken, TF32 is off unless the caller turned it on.
"""

from __future__ import annotations

import torch


def energy(res: torch.Tensor, l1: bool) -> torch.Tensor:
    return res.abs().sum(-1) if l1 else (res * res).sum(-1)


def direction(res: torch.Tensor, l1: bool) -> torch.Tensor:
    x = 2.0 * res
    return torch.where(x > 0, 1.0, -1.0) if l1 else x


def length(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(-1, keepdim=True).sqrt()


def ball_norm(x: torch.Tensor) -> torch.Tensor:
    n = length(x)
    return torch.where(n > 1.0, x / n, x)


def sphere_norm(x: torch.Tensor) -> torch.Tensor:
    return x / length(x)


def truncated_normal(generator: torch.Generator, shape, sigma: float, bound: float) -> torch.Tensor:
    """Normal(0, sigma) truncated to [-bound, bound], drawn on the generator's
    device in one call (the reference's ``randn(0, sigma, -bound, bound)``)."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(out, std=sigma, a=-bound, b=bound, generator=generator)


def touched(n: int, *ids: torch.Tensor) -> torch.Tensor:
    """bool [n, 1]: the rows the ids name (no host sync, unlike ``torch.unique``)."""
    mask = torch.zeros(n, dtype=torch.bool, device=ids[0].device)
    for i in ids:
        mask[i] = True
    return mask[:, None]


def distinct(*ids: torch.Tensor) -> int:
    """How many distinct ids the tensors hold together."""
    return int(torch.unique(torch.cat([i.reshape(-1) for i in ids])).numel())
